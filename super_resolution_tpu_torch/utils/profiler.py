"""``torch.profiler`` trace windows for the train loop and the evaluation
pass (port of super_resolution_tpu/utils/profiler.py, which drives
``jax.profiler``).

Config (``logger.profile`` in the option file), with JAX's keys and
defaults:

.. code-block:: yaml

    logger:
      profile:
        start_iter: 20     # first traced iteration (training)
        num_iters: 3       # iterations in the window (training)
        logdir: ~          # default <experiments_root>/profile, or
                           # <results_root>/profile for test.py

Each window writes one Chrome trace, ``<logdir>/<host>_<pid>.<ms>.pt.trace.
json``, with the host's operators and, where a card is in use, the device
activity: every kernel, those the port launches through ctypes among them
(CUPTI traces the launches of the process). Open it in Perfetto or
``chrome://tracing``, or with TensorBoard's profiler plugin.
"""

from __future__ import annotations

import os

import torch


def _rank(rank) -> int:
    if rank is not None:
        return int(rank)
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _profile(logdir: str):
    """A started profiler that writes its Chrome trace under ``logdir``
    when it stops."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir))
    prof.start()
    return prof


def _synchronize() -> None:
    """Wait for the card's queued work, so that it lands in the trace."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class TraceWindow:
    """Profile an iteration window of the train loop.

    Call :meth:`step` once an iteration, after the update: the window opens
    at ``start_iter`` and closes once ``current_iter`` reaches
    ``start_iter + num_iters``, after the card has finished its queued
    work. Inert when ``cfg`` is None and on a process of rank other than
    0 (one trace a job).
    """

    def __init__(self, cfg: dict | None, default_logdir: str, rank=None):
        self._prof = None
        self._done = cfg is None or _rank(rank) != 0
        cfg = cfg or {}
        self.start_iter = int(cfg.get("start_iter", 10))
        self.end_iter = self.start_iter + int(cfg.get("num_iters", 3))
        self.logdir = cfg.get("logdir") or default_logdir

    def step(self, current_iter: int, block_on=None) -> None:
        """``block_on`` is taken for the JAX signature; the window waits for
        the whole card before it closes."""
        if self._done:
            return
        if self._prof is None and current_iter >= self.start_iter:
            self._prof = _profile(self.logdir)
        if self._prof is not None and current_iter >= self.end_iter:
            self.close()

    def close(self) -> None:
        """Stop an open window (the end of training) and write its trace."""
        if self._prof is not None:
            _synchronize()
            self._prof.stop()
            self._prof = None
            self._done = True


class trace_eval:
    """Context manager that profiles a whole evaluation pass (the tile
    forwards, the copies between host and card, the metrics). Inert when
    ``cfg`` is None and on a process of rank other than 0."""

    def __init__(self, cfg: dict | None, default_logdir: str, rank=None):
        self._on = cfg is not None and _rank(rank) == 0
        self.logdir = (cfg or {}).get("logdir") or default_logdir
        self._prof = None

    def __enter__(self):
        if self._on:
            self._prof = _profile(self.logdir)
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            _synchronize()
            self._prof.stop()
            self._prof = None
        return False
