"""Arbitrary-scale training (port of super_resolution_tpu/arb/train.py;
ref: esc_arb/train.py:19-226): L1 on the sampled pixels, Adam, a multi-step
decay in epochs, a checkpoint every ``epoch_save`` epochs and at the end.
As in JAX there is no validation and no resume.

config (dict or a loaded YAML of options/arb/train-div2k):
  model: {name, args}                       # an arb spec (arb.models.make)
  train_dataset: {type, dataset, ..., batch_size}
  optimizer: {lr}
  epoch_max, multi_step_lr: {milestones, gamma}, epoch_save, seed
"""

from __future__ import annotations

import os
from os import path as osp

import numpy as np
import torch

from super_resolution_tpu_torch.arb.models import make
from super_resolution_tpu_torch.models.arch_util import init_weights
from super_resolution_tpu_torch.utils.logger import get_root_logger


def train_arb(config: dict, save_path: str = "./arb_exp",
              device: str = "cuda"):
    """Train ``config['model']`` from seeded weights (``seed``, default 0)
    on ``device``; returns (model, the loss of every step). Checkpoints go
    to ``save_path/epoch-<n>`` and ``save_path/epoch-last``
    (``runtime/checkpoint.save_params``: {'params': state_dict, 'epoch'}).
    The learning rate of update n is the schedule at n, its milestones
    counted in epochs of ``len(loader)`` steps, as optax's schedule in
    JAX."""
    from super_resolution_tpu_torch.data import TrainLoader, build_dataset
    from super_resolution_tpu_torch.runtime.checkpoint import save_params
    from super_resolution_tpu_torch.runtime.schedulers import \
        multistep_restart_lr

    logger = get_root_logger()
    os.makedirs(save_path, exist_ok=True)
    seed = config.get("seed", 0)
    model = make(config["model"])
    init_weights(model, torch.Generator().manual_seed(seed))
    model = model.to(device).train()
    ds_opt = dict(config["train_dataset"])
    batch_size = ds_opt.pop("batch_size", 16)
    loader = TrainLoader(build_dataset(ds_opt), batch_size=batch_size,
                         seed=seed)

    base_lr = config["optimizer"]["lr"]
    ms = config.get("multi_step_lr")
    if ms:
        steps = max(1, len(loader))
        schedule = multistep_restart_lr(
            base_lr, [m * steps for m in ms["milestones"]],
            ms.get("gamma", 0.5))
    else:
        def schedule(step):
            return base_lr
    optimizer = torch.optim.Adam(model.parameters(), lr=base_lr)

    def checkpoint(name: str, epoch: int) -> None:
        save_params(osp.join(save_path, name),
                    {"params": {k: v.detach().cpu() for k, v in
                                model.state_dict().items()},
                     "epoch": epoch})

    epoch_max = config.get("epoch_max", 1)
    losses, step = [], 0
    for epoch in range(1, epoch_max + 1):
        first = len(losses)
        for batch in loader.epoch_iter(epoch):
            data = {k: torch.from_numpy(v).to(device)
                    for k, v in batch.items() if isinstance(v, np.ndarray)}
            for group in optimizer.param_groups:
                group["lr"] = schedule(step)
            pred = model(data["inp"], data["coord"], data["cell"])
            loss = (pred - data["gt"]).abs().mean()
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()
            step += 1
            losses.append(float(loss.detach()))
        logger.info(f"[arb] epoch {epoch}/{epoch_max} "
                    f"loss={np.mean(losses[first:]):.4f}")
        if epoch % config.get("epoch_save", 1) == 0:
            checkpoint(f"epoch-{epoch}", epoch)
    checkpoint("epoch-last", epoch_max)
    return model, losses
