"""The training core: optimizer, train state with EMA, and the SR train step
(port of super_resolution_tpu/runtime/train_loop.py; ref:
basicsr/models/base_model.py optimizer :103-120, EMA :75-82, schedulers
:122-133, sr_model.py ``optimize_parameters`` :92-119).

The JAX package's state is a pure pytree updated by a jitted function; here
:class:`TrainState` holds the network, a ``torch.optim`` optimizer and an
EMA copy of the network, and the step updates them in place. What it keeps
of the JAX step's arithmetic:

- the learning rate of an update is the schedule at the number of updates
  made before it (optax's count), set on every parameter group before
  ``step()``;
- ``Adam`` with a nonzero ``weight_decay`` is decoupled decay, as
  ``optax.adamw`` (``torch.optim.AdamW``), not ``torch.optim.Adam``'s L2;
- ``grad_clip_norm`` scales every gradient by max_norm / norm where the
  global norm reaches max_norm (``optax.clip_by_global_norm``);
- a parameter that got no gradient gets a zero one, so that every moment
  and step count moves as optax's do;
- ``lr_mult_rules`` make parameter groups whose learning rate is the
  schedule's times their multiplier (``optax.multi_transform``), and a
  freeze mask zeroes gradients before the clip (JAX's ``grad_mask``);
- EMA: e = e * decay + p * (1 - decay) after each update;
- ``use_amp``: the forward runs on bf16 casts of the float32 parameters and
  a bf16 input, the output and the loss in float32.
"""

from __future__ import annotations

import copy
import inspect
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Callable

import torch

from super_resolution_tpu_torch.losses import build_loss
from super_resolution_tpu_torch.runtime.schedulers import build_schedule
from super_resolution_tpu_torch.utils.precision import cast_parameters


@dataclass
class TrainState:
    """``step``: updates made."""

    net: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    ema: torch.nn.Module | None = None
    step: int = 0


def name_contains(name: str, needles) -> bool:
    """Whether a parameter's torch name holds any of ``needles`` (JAX's
    ``_path_contains`` on the flax path: the networks keep BasicSR's module
    names, so a needle selects the same parameters in both)."""
    return any(n in name for n in needles)


def lr_groups(named_params, lr_mult_rules: dict | None) -> list:
    """Parameter groups for per-group learning rates (the reference's
    ``dcn_lr_mul`` / ``flow_lr_mul``, edvr_model.py:19-46,
    video_recurrent_model.py:22-48): a parameter goes to the first rule in
    ``lr_mult_rules`` ({substring: multiplier}) whose substring its name
    holds, else to the default group; each group keeps its ``lr_mult``."""
    rules = dict(lr_mult_rules or {})
    groups = {needle: [] for needle in rules}
    groups[None] = []
    for name, p in named_params:
        label = next((n for n in rules if name_contains(name, (n,))), None)
        groups[label].append(p)
    return [{"params": ps, "lr_mult": 1.0 if needle is None
             else float(rules[needle])}
            for needle, ps in groups.items() if ps]


def build_optimizer(train_opt: dict, params, lr_mult_rules=None):
    """The optimizer of the ``optim_g`` block (Adam, AdamW or SGD) and the
    schedule of :func:`build_schedule`. ``params``: parameters, one group;
    with ``lr_mult_rules`` ({substring: multiplier}, JAX's
    ``optax.multi_transform``), (name, parameter) pairs, grouped by
    :func:`lr_groups`."""
    opt = dict(train_opt["optim_g"])
    opt_type = opt.pop("type")
    schedule = build_schedule(train_opt)
    betas = tuple(opt.pop("betas", (0.9, 0.999)))
    weight_decay = opt.pop("weight_decay", 0.0)
    if lr_mult_rules:
        params = lr_groups(params, lr_mult_rules)

    lr = schedule(0)
    if opt_type == "Adam" and not weight_decay:
        optimizer = torch.optim.Adam(params, lr=lr, betas=betas,
                                     eps=1e-8)
    elif opt_type in ("Adam", "AdamW"):
        optimizer = torch.optim.AdamW(params, lr=lr, betas=betas,
                                      eps=1e-8, weight_decay=weight_decay)
    elif opt_type == "SGD":
        optimizer = torch.optim.SGD(params, lr=lr,
                                    momentum=opt.pop("momentum", 0.0))
    else:
        raise NotImplementedError(f"optimizer {opt_type}")
    return optimizer, schedule


def make_freeze_mask(freeze_rules: list | None):
    """Staged freezing (JAX ``make_freeze_mask``): rules ``(needles,
    until_iter)`` freeze the parameters whose name holds a needle while
    fewer than until_iter updates are made (None: for good); ``('only',
    needles, until_iter)`` freezes every parameter but those (EDVR's
    TSA-only phase, ref: edvr_model.py:48-61). Returns f(named_params,
    step) that zero-fills the frozen parameters' gradients in place, or
    None. The frozen parameters stay in the optimizer and keep
    ``requires_grad``, so that Adam's step counts and AdamW's decay move as
    optax's do."""
    if not freeze_rules:
        return None

    def frozen(name: str, step: int) -> bool:
        for rule in freeze_rules:
            if rule[0] == "only":
                _, needles, until = rule
                hit = not name_contains(name, needles)
            else:
                needles, until = rule
                hit = name_contains(name, needles)
            if hit and (until is None or step < until):
                return True
        return False

    def mask(named_params, step: int) -> None:
        for name, p in named_params:
            if p.grad is not None and frozen(name, step):
                p.grad.zero_()

    return mask


def build_pixel_criterion(train_opt: dict):
    if train_opt.get("pixel_opt"):
        return build_loss(train_opt["pixel_opt"])
    return None


def init_train_state(net: torch.nn.Module, train_opt: dict,
                     lr_mult_rules: dict | None = None) -> TrainState:
    """The state of a run that starts: the optimizer over ``net``'s
    parameters (grouped by ``lr_mult_rules``) and, where ``ema_decay`` >
    0, an EMA copy of ``net`` (eval mode, no gradients)."""
    optimizer, schedule = build_optimizer(
        train_opt, net.named_parameters() if lr_mult_rules
        else net.parameters(), lr_mult_rules)
    ema = None
    if train_opt.get("ema_decay", 0) > 0:
        ema = copy.deepcopy(net).eval().requires_grad_(False)
    return TrainState(net=net, optimizer=optimizer, schedule=schedule,
                      ema=ema)


def filled_grads(state: TrainState) -> list:
    """:func:`fill_missing_grads` of the state's optimizer."""
    return fill_missing_grads(state.optimizer)


def fill_missing_grads(optimizer: torch.optim.Optimizer) -> list:
    """The gradient of every parameter ``optimizer`` updates, a zero one
    given to each that got none (so that every moment and step count moves
    as optax's do), averaged over the ranks of data parallelism
    (:func:`average_grads`)."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    average_grads(optimizer, grads)
    return grads


def average_grads(optimizer: torch.optim.Optimizer, grads=None) -> None:
    """Average the gradients of ``optimizer`` (or ``grads``) over the
    ``data`` axis where ``parallel.mesh.attach_data_parallel`` gave it
    one: with equal local batches, the gradient of the global-batch
    mean."""
    group = getattr(optimizer, "data_parallel_group", None)
    if group is None:
        return
    from super_resolution_tpu_torch.parallel.mesh import all_reduce_mean_

    if grads is None:
        grads = [p.grad for g in optimizer.param_groups
                 for p in g["params"] if p.grad is not None]
    all_reduce_mean_(grads, group)


def global_norm(grads: list) -> torch.Tensor:
    """The float32 norm of all gradients together (``optax.global_norm``)."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))


def clip_by_global_norm(grads: list, max_norm: float) -> None:
    norm = global_norm(grads)
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(grads, scale.to(grads[0].dtype))


def apply_update(state: TrainState, ema_decay: float) -> None:
    """The optimizer's update at the learning rate schedule(updates made),
    then the EMA: e = e * decay + p * (1 - decay); one more update made."""
    lr = state.schedule(state.step)
    for group in state.optimizer.param_groups:
        group["lr"] = lr * group.get("lr_mult", 1.0)
    state.optimizer.step()
    update_ema(state, ema_decay)
    state.step += 1


def update_ema(state: TrainState, ema_decay: float) -> None:
    """e = e * decay + p * (1 - decay) where the state keeps an EMA."""
    if state.ema is not None:
        with torch.no_grad():
            ema = list(state.ema.parameters())
            torch._foreach_mul_(ema, ema_decay)
            torch._foreach_add_(ema, list(state.net.parameters()),
                                alpha=1 - ema_decay)


def make_sr_train_step(train_opt: dict, grad_mask=None):
    """The single-network SR step: f(state, batch, generator) -> logs, which
    updates ``state`` in place. batch: {'lq': (B, h, w, 3), 'gt': (B, H, W,
    3)} float32 tensors on the network's device; ``generator`` goes to the
    network's forward, which draws the drop path from it where it has one
    (``models.arch_util.SRShell``; a network whose forward takes no
    generator runs without it, as flax ignores an rng a module does not
    draw from). logs: {'l_pix': the loss, a 0-d tensor on the device}.
    ``grad_mask`` (:func:`make_freeze_mask`) zeroes the frozen gradients
    before the clip and the update, as JAX's does."""
    cri_pix = build_pixel_criterion(train_opt)
    if cri_pix is None:
        raise ValueError("train.pixel_opt is required for the SR step")
    ema_decay = train_opt.get("ema_decay", 0)
    use_amp = bool(train_opt.get("use_amp", False))
    clip = train_opt.get("grad_clip_norm")

    def train_step(state: TrainState, batch: dict, generator=None) -> dict:
        net = state.net
        net.train()
        state.optimizer.zero_grad(set_to_none=False)
        lq = batch["lq"]
        with (cast_parameters(net, torch.bfloat16) if use_amp
              else nullcontext()):
            if use_amp:
                lq = lq.to(torch.bfloat16)
            kw = ({"generator": generator} if "generator"
                  in inspect.signature(net.forward).parameters else {})
            sr = net(lq, **kw).float()
            l_pix = cri_pix(sr, batch["gt"])
            # inside the context: a checkpointed region recomputes here
            l_pix.backward()
        grads = filled_grads(state)
        if grad_mask is not None:
            grad_mask(net.named_parameters(), state.step)
        if clip:
            clip_by_global_norm(grads, clip)
        apply_update(state, ema_decay)
        return {"l_pix": l_pix.detach()}

    return train_step
