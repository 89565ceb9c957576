"""ESRModel, the runner the ESC option files name: the ESC training strategy
(port of super_resolution_tpu/runtime/esr_model.py; ref: HAT/ESC/esc/
models/esr_model.py:20-410). At inference it is a :class:`HATModel`.

What its step keeps of the JAX step's arithmetic, where it differs from
:class:`SRModel`'s (``runtime/train_loop.py``):

- ``use_amp`` is read from the top level of the options, not from
  ``train:``: the forward runs on bf16 casts of the float32 parameters and
  a bf16 LQ, the output in float32;
- the optimizer is Adam where ``optim_g.weight_decay`` is 0 and AdamW
  (decoupled decay, as ``optax.adamw``) otherwise, betas (0.9, 0.999)
  unless given; ``optim_g.type`` is not read;
- ``gradient_clip`` scales every gradient by min(1, cv / (norm + 1e-12)),
  with cv halved once more than 50 000 updates were made (ref: :203-210);
- MESA self-distillation (``mesa_opt``, its ``start_ratio`` 0.33 by
  default): from iteration int(start_ratio * total_iter) on, the loss adds
  ``mesa_opt``'s loss between the output and the EMA network's float32
  output on the float32 LQ, which records no gradient; before that
  ``l_mesa`` is logged as 0.0;
- every ``reset_momentum_iter`` iterations Adam's step count and moments
  start again (ref: :155-159), and the runner logs it;
- the network runs deterministic, as JAX's step, which passes no
  drop-path key, so ``save`` keeps no generator state.

One deliberate difference: JAX re-initialises the whole optax state at a
momentum reset, so its schedule's count, warmup included, starts again at
0; here the learning rate stays schedule(updates made), as the reference's
optimizer and its reported learning rate keep it (ROADMAP.md queue 3).

``perceptual_opt`` adds the VGG perceptual and style terms
(``losses/perceptual.py``) on the float32 output against the GT, as JAX's
step does (logged as ``l_percep`` and ``l_style``); the pixel loss may then
be absent. ``wave_opt`` raises, as in JAX: the reference builds no wavelet
loss.
"""

from __future__ import annotations

from contextlib import nullcontext

import torch

from super_resolution_tpu_torch.losses import build_loss
from super_resolution_tpu_torch.runtime.sr_model import HATModel
from super_resolution_tpu_torch.runtime.train_loop import (
    TrainState, apply_update, build_pixel_criterion, filled_grads,
    global_norm, init_train_state)
from super_resolution_tpu_torch.utils.precision import cast_parameters
from super_resolution_tpu_torch.utils.registry import MODEL_REGISTRY

# the update count after which the clip threshold halves (ref: :203-210)
CLIP_HALVING_STEP = 50000


def make_esr_train_step(train_opt: dict, use_amp: bool, cri_mesa=None,
                        cri_perceptual=None):
    """ESRModel's step: f(state, batch, use_mesa) -> logs, which updates
    ``state`` in place. batch: {'lq', 'gt'} float32 tensors on the
    network's device; ``cri_perceptual``: a ``PerceptualLoss`` on that
    device or None; logs: {'l_pix', 'l_percep', 'l_style', 'l_mesa'}, those
    the step computes, 0-d tensors."""
    cri_pix = build_pixel_criterion(train_opt)
    if cri_pix is None and cri_perceptual is None:
        raise ValueError("Pixel and perceptual losses are both None.")
    ema_decay = train_opt.get("ema_decay", 0)
    clip = train_opt.get("gradient_clip")

    def train_step(state: TrainState, batch: dict, use_mesa: bool) -> dict:
        net = state.net.eval()
        state.optimizer.zero_grad(set_to_none=False)
        lq = batch["lq"]
        with (cast_parameters(net, torch.bfloat16) if use_amp
              else nullcontext()):
            sr = net(lq.to(torch.bfloat16) if use_amp else lq).float()
            terms = {}
            if cri_pix is not None:
                terms["l_pix"] = cri_pix(sr, batch["gt"])
            if cri_perceptual is not None:
                terms["l_percep"], terms["l_style"] = cri_perceptual(
                    sr, batch["gt"])
            terms = {k: v for k, v in terms.items() if v is not None}
            logs = {k: v.detach() for k, v in terms.items()}
            total = sum(terms.values())
            if use_mesa:
                with torch.no_grad():
                    ema_out = state.ema(lq)
                l_mesa = cri_mesa(sr, ema_out)
                logs["l_mesa"] = l_mesa.detach()
                total = total + l_mesa
            total.backward()
        grads = filled_grads(state)
        if clip is not None:
            cv = clip / 2.0 if state.step > CLIP_HALVING_STEP else clip
            factor = torch.clamp(cv / (global_norm(grads) + 1e-12), max=1.0)
            torch._foreach_mul_(grads, factor.to(grads[0].dtype))
        apply_update(state, ema_decay)
        return logs

    return train_step


def reset_momentum(optimizer: torch.optim.Optimizer) -> None:
    """Adam's step count and both moments start again at the next update."""
    optimizer.state.clear()


@MODEL_REGISTRY.register()
class ESRModel(HATModel):
    """The ESC runner: :class:`HATModel`'s inference and validation, the ESC
    training strategy (the module docstring)."""

    def setup_training(self, mesh=None) -> None:
        """The ESC strategy's state; ``mesh``: data parallelism over its
        ``data`` axis (``realgan.runner_data_parallel``)."""
        from super_resolution_tpu_torch.runtime.realgan import \
            runner_data_parallel

        train_opt = self.opt["train"]
        if train_opt.get("wave_opt"):
            raise NotImplementedError(
                "wave_opt: the reference registers no wavelet loss anywhere; "
                "refusing to silently ignore it")
        self.cri_perceptual = None
        if train_opt.get("perceptual_opt"):
            self.cri_perceptual = build_loss(
                train_opt["perceptual_opt"]).to(self.device)
        self.use_amp = bool(self.opt.get("use_amp", False))
        self.reset_momentum_iter = train_opt.get("reset_momentum_iter")
        self.cri_mesa, self.mesa_start_iter = None, None
        if train_opt.get("mesa_opt"):
            if not train_opt.get("ema_decay", 0) > 0:
                raise ValueError("mesa_opt distils from the EMA network: "
                                 "train.ema_decay must be above 0")
            mesa_opt = dict(train_opt["mesa_opt"])
            start_ratio = mesa_opt.pop("start_ratio", 0.33)
            self.mesa_start_iter = int(start_ratio * train_opt["total_iter"])
            self.cri_mesa = build_loss(mesa_opt)
        # Adam, which build_optimizer makes AdamW where weight_decay is set
        optim = dict(train_opt["optim_g"], type="Adam")
        self.state = init_train_state(self.net_g,
                                      dict(train_opt, optim_g=optim))
        self._train_step = make_esr_train_step(train_opt, self.use_amp,
                                               self.cri_mesa,
                                               self.cri_perceptual)
        runner_data_parallel(self, mesh)
        self._eval_net = None
        self.log_dict = {}

    def optimize_parameters(self, batch: dict, current_iter: int) -> None:
        data = {"lq": self._to_device(batch["lq"]),
                "gt": self._to_device(batch["gt"])}
        use_mesa = (self.cri_mesa is not None
                    and current_iter >= self.mesa_start_iter)
        self.log_dict = self._train_step(self.state, data, use_mesa)
        if self.cri_mesa is not None and not use_mesa:
            self.log_dict["l_mesa"] = 0.0
        self._eval_net = None
        if (self.reset_momentum_iter
                and current_iter % self.reset_momentum_iter == 0):
            self.logger.info(f"Reset momentums for net_g at iteration "
                             f"{current_iter}")
            reset_momentum(self.state.optimizer)
