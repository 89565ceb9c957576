"""Training checkpoints with the reference's two parameter keys (port of
super_resolution_tpu/runtime/checkpoint.py; ref: base_model.py:207-252,
sr_model.py:274-279).

The JAX package writes one orbax directory ``net_g_{iter}``; the port keeps
that layout and writes one ``torch.save`` file in it, :data:`STATE_FILE`,
holding {'params', 'params_ema', 'opt_state', 'epoch', 'iter', ...} under
the port's torch names. Its 'params' load strict as a ``.pth`` through the
runner's ``load_network``. The two packages' checkpoints are not
interchangeable: the JAX package reads orbax directories, the port reads
this file."""

from __future__ import annotations

import os
import time
from os import path as osp

import torch
import torch.distributed

from super_resolution_tpu_torch.utils.logger import get_root_logger

STATE_FILE = "state.pth"


def state_file(path: str) -> str:
    """The file of a checkpoint directory, or ``path`` if it is a file."""
    return osp.join(path, STATE_FILE) if osp.isdir(path) else path


def save_params(path: str, tree: dict, retries: int = 3) -> None:
    """Write ``tree`` to the directory ``path`` (created), through a
    temporary file renamed into place; in a process group only rank 0
    writes (every rank builds the tree: under tensor or pipeline
    parallelism that gathers it). An OSError is retried, 1 s apart (ref:
    base_model.py:237-252); the last one raises."""
    if torch.distributed.is_initialized() and torch.distributed.get_rank():
        return
    last_exc = None
    for attempt in range(retries):
        try:
            os.makedirs(path, exist_ok=True)
            tmp = osp.join(path, f".{STATE_FILE}.{os.getpid()}.tmp")
            torch.save(tree, tmp)
            os.replace(tmp, osp.join(path, STATE_FILE))
            return
        except OSError as exc:
            last_exc = exc
            get_root_logger().warning(
                f"checkpoint save to {path} failed (attempt {attempt + 1}/"
                f"{retries}): {exc}")
            time.sleep(1)
    raise last_exc


def load_tree(path: str) -> dict:
    """Everything a checkpoint holds, its tensors on the CPU."""
    return torch.load(state_file(path), map_location="cpu",
                      weights_only=True)


def load_params(path: str, param_key: str = "params") -> dict:
    """One state dict out of a checkpoint or a reference ``.pth``:
    ``param_key``, else 'params', else 'params_ema', else the file's dict
    itself (a bare state dict)."""
    tree = load_tree(path)
    for key in (param_key, "params", "params_ema"):
        if key in tree:
            return tree[key]
    return tree
