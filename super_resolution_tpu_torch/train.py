"""Train CLI: ``python -m super_resolution_tpu_torch.train -opt
options/train/train_HAT_SRx4_from_scratch.yml`` (port of
super_resolution_tpu/train.py). It takes the JAX CLI's flags
(``--force_yml``, ``--debug``, ``--auto_resume``, ``--launcher none``) and
``--device`` (default ``cuda``; ``--device cpu`` on a machine without a
card). Relative paths in the options resolve against the working
directory; a run goes under ``<repository root>/experiments/<name>`` unless
``path: {experiments_root: ...}`` says otherwise."""

import os.path as osp

from super_resolution_tpu_torch.runtime.train_pipeline import train_pipeline

if __name__ == "__main__":
    root_path = osp.abspath(osp.join(__file__, osp.pardir, osp.pardir))
    train_pipeline(root_path)
