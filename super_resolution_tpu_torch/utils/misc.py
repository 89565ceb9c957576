"""Small utilities: seeding, experiment directories, scandir (port of
super_resolution_tpu/utils/misc.py; ref: basicsr/utils/misc.py)."""

from __future__ import annotations

import os
import random
import time
from os import path as osp

import numpy as np


def set_random_seed(seed: int) -> None:
    """Seed python, numpy and torch's default generator (the runners draw
    their weights from a ``torch.Generator`` of their own)."""
    import torch

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def get_time_str() -> str:
    return time.strftime("%Y%m%d_%H%M%S", time.localtime())


def mkdir_and_rename(path: str) -> None:
    """If path exists, archive-rename it with a timestamp then recreate
    (ref: misc.py:24-35)."""
    if osp.exists(path):
        new_name = path + "_archived_" + get_time_str()
        print(f"Path already exists. Rename it to {new_name}", flush=True)
        os.rename(path, new_name)
    os.makedirs(path, exist_ok=True)


def make_exp_dirs(opt: dict) -> None:
    """Create the run's directories (rank 0 only): the experiments root of
    a training run or the results root of a test run is archived if it
    exists, the other paths are created."""
    if opt.get("rank", 0) != 0:
        return
    path_opt = dict(opt["path"])
    mkdir_and_rename(path_opt.pop("experiments_root" if opt.get("is_train")
                                  else "results_root"))
    for key, path in path_opt.items():
        if ("strict_load" in key or "pretrain_network" in key
                or "resume" in key or "param_key" in key):
            continue
        if path is not None:
            os.makedirs(path, exist_ok=True)


def scandir(dir_path: str, suffix=None, recursive: bool = False,
            full_path: bool = False):
    """Recursively yield file paths under dir_path (ref: misc.py::scandir)."""
    if suffix is not None and not isinstance(suffix, (str, tuple)):
        raise TypeError("suffix must be a string or tuple of strings")
    root = dir_path

    def _scandir(dir_path, suffix, recursive):
        for entry in os.scandir(dir_path):
            if not entry.name.startswith(".") and entry.is_file():
                rel = entry.path if full_path else osp.relpath(entry.path,
                                                               root)
                if suffix is None or rel.endswith(suffix):
                    yield rel
            elif recursive and entry.is_dir():
                yield from _scandir(entry.path, suffix, recursive)

    return _scandir(dir_path, suffix, recursive)
