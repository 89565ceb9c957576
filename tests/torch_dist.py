"""Runs a function on a few gloo ranks of the CPU for the port's parallel
tests: ``run_ranks(fn, world, tmp_path, payload)`` spawns ``world``
processes (``torch.multiprocessing``), joins them in a gloo process group
through a ``file://`` store under ``tmp_path`` (no TCP port), calls
``fn(rank, world, payload)`` in each, and returns the dicts they return, in
rank order. ``fn`` must live in a module that imports no JAX (the workers
import it): ``tests/torch_parallel_workers.py``.
"""

from __future__ import annotations

import os
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, fn, world, store, payload, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        result = fn(rank, world, payload)
    except Exception:
        result = {"__error__": traceback.format_exc()}
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def run_ranks(fn, world: int, tmp_path, payload=None) -> list:
    """[fn(rank, world, payload) for each rank], run on ``world`` gloo
    ranks; a worker's exception is raised here with its traceback."""
    tmp = str(tmp_path)
    store = os.path.join(tmp, "store")
    if os.path.exists(store):
        os.remove(store)
    for r in range(world):
        out = os.path.join(tmp, f"rank{r}.pt")
        if os.path.exists(out):
            os.remove(out)
    mp.start_processes(_entry, args=(fn, world, store, payload, tmp),
                       nprocs=world, join=True, start_method="spawn")
    results = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                          weights_only=False) for r in range(world)]
    for r, res in enumerate(results):
        if isinstance(res, dict) and "__error__" in res:
            raise AssertionError(f"rank {r} failed:\n{res['__error__']}")
    return results
