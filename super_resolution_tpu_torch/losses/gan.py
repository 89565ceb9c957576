"""GAN losses (port of the GANLoss and MultiScaleGANLoss of
super_resolution_tpu/losses/gan.py; ref: basicsr/losses/gan_loss.py).

``gan_type`` is one of vanilla, lsgan, wgan, wgan_softplus and hinge. The
penalties (R1, the WGAN-GP interpolation penalty, StyleGAN2's path length)
differentiate through a gradient: ``torch.autograd.grad(...,
create_graph=True)``, where JAX nests ``jax.grad``. Their random draws (the
interpolation weights, the path noise) are handed in or drawn from a
``torch.Generator``, where JAX takes a key. ``GANFeatLoss`` is the
feature-matching loss of the HiFaceGAN runner.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
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


def r1_penalty(real_pred, real_img):
    """R1: E[|d sum(D(x)) / dx|^2] over the batch (ref:
    gan_loss.py::r1_penalty). ``real_img`` requires grad and ``real_pred``
    is D's output on it; the result keeps the graph for a backward."""
    grad = torch.autograd.grad(real_pred.sum(), real_img,
                               create_graph=True)[0]
    return grad.pow(2).reshape(grad.shape[0], -1).sum(1).mean()


def gradient_penalty_loss(disc_fn, real, fake, alpha=None, generator=None):
    """WGAN-GP: E[(|grad D(a real + (1 - a) fake)| - 1)^2], the norm with
    JAX's 1e-12 inside the root (ref: gan_loss.py::gradient_penalty_loss).
    ``alpha`` (B, 1, ..., 1) uniform draws, else drawn from ``generator``."""
    if alpha is None:
        alpha = torch.rand((real.shape[0],) + (1,) * (real.ndim - 1),
                           generator=generator, device=real.device,
                           dtype=real.dtype)
    interp = real * alpha + fake * (1 - alpha)
    if not interp.requires_grad:
        interp.requires_grad_(True)
    grad = torch.autograd.grad(disc_fn(interp).sum(), interp,
                               create_graph=True)[0]
    norms = torch.sqrt(grad.pow(2).reshape(grad.shape[0], -1).sum(1) + 1e-12)
    return ((norms - 1.0) ** 2).mean()


def g_path_regularize(fake_img, latents, mean_path_length, noise=None,
                      generator=None, decay: float = 0.01, group=None):
    """StyleGAN2's path-length penalty (ref: gan_loss.py:159-168).

    fake_img: (B, H, W, 3), the generator's NHWC output computed from
    ``latents`` (B, L, C); noise: a standard normal of fake_img's shape
    (divided here by sqrt(H W)), else drawn from ``generator``. Returns
    (penalty with its graph, mean path length, new mean path length), the
    last two detached. ``group``: the ranks of data parallelism, each on
    an equal share of the batch; the mean path length is then the whole
    batch's, summed over the ranks forward and backward, so that the
    averaged gradients equal the one-process penalty's."""
    if noise is None:
        noise = torch.randn(fake_img.shape, generator=generator,
                            device=fake_img.device, dtype=fake_img.dtype)
    noise = noise / math.sqrt(fake_img.shape[1] * fake_img.shape[2])
    grad = torch.autograd.grad((fake_img * noise).sum(), latents,
                               create_graph=True)[0]
    path_lengths = torch.sqrt(grad.pow(2).sum(2).mean(1))
    batch_mean = path_lengths.mean()
    if group is not None:
        from super_resolution_tpu_torch.parallel.mesh import (
            copy_to_group, reduce_from_group)

        batch_mean = reduce_from_group(copy_to_group(batch_mean, group),
                                       group) / dist.get_world_size(group)
    path_mean = mean_path_length + decay * (batch_mean - mean_path_length)
    path_penalty = (path_lengths - path_mean).pow(2).mean()
    return path_penalty, batch_mean.detach(), path_mean.detach()


@LOSS_REGISTRY.register()
class GANFeatLoss:
    """pix2pixHD feature matching over a multiscale discriminator's
    features: for each of the D scales, the criterion between every
    intermediate feature of the fake and the detached real one, over D
    (ref: the GANFeatLoss HiFaceGAN's feature_matching_opt names)."""

    def __init__(self, criterion: str = "l1", loss_weight: float = 1.0,
                 reduction: str = "mean"):
        crits = {"l1": lambda a, b: (a - b).abs().mean(),
                 "l2": lambda a, b: ((a - b) ** 2).mean(),
                 "charbonnier": lambda a, b: torch.sqrt(
                     (a - b) ** 2 + 1e-12).mean()}
        if criterion not in crits:
            raise ValueError(f"Unsupported criterion {criterion}")
        self.crit = crits[criterion]
        self.loss_weight = loss_weight

    def __call__(self, pred_fake, pred_real):
        num_d = len(pred_fake)
        loss = 0.0
        for fake, real in zip(pred_fake, pred_real):
            for f, r in zip(fake[:-1], real[:-1]):
                loss = loss + self.crit(f, r.detach()) / num_d
        return loss * self.loss_weight
