"""Learning-rate schedules as plain functions of the step (port of
super_resolution_tpu/runtime/schedulers.py; ref:
basicsr/models/lr_scheduler.py and the warmup of base_model.py:181-202).

Each schedule maps an update count (0 for the first update) to a learning
rate, as optax evaluates its schedules; the train step sets the optimizer's
learning rate from it before every update. ``torch.optim.lr_scheduler`` is
not used: its ``step()`` convention counts differently."""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np


def multistep_restart_lr(base_lr: float, milestones: Sequence[int],
                         gamma: float = 0.1,
                         restarts: Sequence[int] = (0,),
                         restart_weights: Sequence[float] = (1,)):
    """Step decay at milestones; the rate resets to base_lr x weight at each
    restart, and milestones at or before the restart in force stop counting
    (ref: lr_scheduler.py:27-33). A milestone listed twice decays twice."""
    order = np.argsort(restarts)
    restarts = np.asarray(restarts)[order]
    weights = np.asarray(restart_weights, dtype=np.float64)[order]
    milestones = np.asarray(sorted(milestones))

    def schedule(step: int) -> float:
        idx = int(np.clip(np.sum(step >= restarts) - 1, 0, len(weights) - 1))
        boundary, w = restarts[idx], weights[idx]
        n_decays = int(np.sum((step >= milestones) & (milestones > boundary)))
        return float(np.float32(base_lr * w * gamma ** n_decays))

    return schedule


def cosine_annealing_restart_lr(base_lr: float, periods: Sequence[int],
                                restart_weights: Sequence[float] = (1,),
                                eta_min: float = 0.0):
    """Cosine annealing with restarts (ref: lr_scheduler.py:57-96): in cycle
    i of length periods[i], lr = eta_min + w_i * 0.5 * (base - eta_min) *
    (1 + cos(pi * t / period_i)). A step on a cycle's end belongs to the
    cycle that ends there (the rate is eta_min)."""
    if len(periods) != len(restart_weights):
        raise ValueError("periods and restart_weights differ in length")
    ends = np.cumsum(periods)
    starts = np.concatenate([[0], ends[:-1]])

    def schedule(step: int) -> float:
        idx = int(np.clip(np.sum(step > ends), 0, len(periods) - 1))
        period = float(periods[idx])
        t = min(max(step - float(starts[idx]), 0.0), period)
        lr = eta_min + restart_weights[idx] * 0.5 * (base_lr - eta_min) * (
            1 + math.cos(math.pi * t / period))
        return float(np.float32(lr))

    return schedule


def with_warmup(schedule, warmup_iter: int):
    """A linear warmup factor (step + 1) / warmup_iter, at most 1, over the
    first warmup_iter steps (ref: base_model.py:181-202)."""
    if warmup_iter <= 0:
        return schedule

    def warmed(step: int) -> float:
        frac = min(max((step + 1) / warmup_iter, 0.0), 1.0)
        return float(np.float32(schedule(step)) * np.float32(frac))

    return warmed


def build_schedule(train_opt: dict):
    """The schedule of a ``train`` option block: ``scheduler`` (MultiStepLR,
    MultiStepRestartLR or CosineAnnealingRestartLR), ``optim_g.lr`` and
    ``warmup_iter``."""
    sched_opt = dict(train_opt["scheduler"])
    sched_type = sched_opt.pop("type")
    base_lr = train_opt["optim_g"]["lr"]
    if sched_type in ("MultiStepLR", "MultiStepRestartLR"):
        schedule = multistep_restart_lr(base_lr, **sched_opt)
    elif sched_type == "CosineAnnealingRestartLR":
        schedule = cosine_annealing_restart_lr(base_lr, **sched_opt)
    else:
        raise ValueError(f"Unsupported scheduler: {sched_type}")
    return with_warmup(schedule, train_opt.get("warmup_iter", -1))
