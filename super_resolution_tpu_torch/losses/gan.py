"""GAN losses (port of the GANLoss and MultiScaleGANLoss of
super_resolution_tpu/losses/gan.py; ref: basicsr/losses/gan_loss.py).

``gan_type`` is one of vanilla, lsgan, wgan, wgan_softplus and hinge. The
penalties and the feature-matching loss of the same JAX module serve the
StyleGAN and HiFaceGAN runners and are not ported (ROADMAP.md queue 1).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from super_resolution_tpu_torch.utils.registry import LOSS_REGISTRY

GAN_TYPES = ("vanilla", "lsgan", "wgan", "wgan_softplus", "hinge")


def _bce_with_logits(logits, targets):
    """The mean sigmoid cross-entropy, in the JAX package's stable form."""
    return (torch.clamp(logits, min=0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs()))).mean()


@LOSS_REGISTRY.register()
class GANLoss:
    """``__call__(pred, target_is_real, is_disc)``: the discriminator's
    loss keeps unit weight, the generator's is scaled by ``loss_weight``
    (ref: gan_loss.py:97-100)."""

    def __init__(self, gan_type: str, real_label_val: float = 1.0,
                 fake_label_val: float = 0.0, loss_weight: float = 1.0):
        if gan_type not in GAN_TYPES:
            raise NotImplementedError(
                f"GAN type {gan_type} is not implemented.")
        self.gan_type = gan_type
        self.real_label_val = real_label_val
        self.fake_label_val = fake_label_val
        self.loss_weight = loss_weight

    def __call__(self, pred, target_is_real: bool, is_disc: bool = False):
        target = self.real_label_val if target_is_real else self.fake_label_val
        if self.gan_type == "vanilla":
            loss = _bce_with_logits(pred, torch.full_like(pred, target))
        elif self.gan_type == "lsgan":
            loss = ((pred - target) ** 2).mean()
        elif self.gan_type == "wgan":
            loss = -pred.mean() if target_is_real else pred.mean()
        elif self.gan_type == "wgan_softplus":
            loss = (F.softplus(-pred).mean() if target_is_real
                    else F.softplus(pred).mean())
        elif is_disc:  # hinge
            loss = F.relu(1 + (-pred if target_is_real else pred)).mean()
        else:
            loss = -pred.mean()
        return loss if is_disc else loss * self.loss_weight


@LOSS_REGISTRY.register()
class MultiScaleGANLoss(GANLoss):
    """GANLoss averaged over a list of predictions, the last of each where
    an entry is itself a list (ref: gan_loss.py::MultiScaleGANLoss)."""

    def __call__(self, pred, target_is_real: bool, is_disc: bool = False):
        if isinstance(pred, (list, tuple)):
            total = 0.0
            for p in pred:
                if isinstance(p, (list, tuple)):
                    p = p[-1]
                total = total + super().__call__(p, target_is_real, is_disc)
            return total / len(pred)
        return super().__call__(pred, target_is_real, is_disc)
