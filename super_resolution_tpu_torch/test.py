"""Test CLI: ``python -m super_resolution_tpu_torch.test -opt
options/test/HAT_SRx4.yml`` (port of super_resolution_tpu/test.py). It takes
the JAX CLI's flags (``--force_yml``, ``--debug``, ``--auto_resume``,
``--launcher none``) and ``--device`` (default ``cuda``; ``--device cpu``
on a machine without a card). Relative paths in the options resolve against
the working directory; results go under ``<repository root>/results``
unless ``path: {results_root: ...}`` says otherwise."""

import os.path as osp

from super_resolution_tpu_torch.runtime.test_pipeline import test_pipeline

if __name__ == "__main__":
    root_path = osp.abspath(osp.join(__file__, osp.pardir, osp.pardir))
    test_pipeline(root_path)
