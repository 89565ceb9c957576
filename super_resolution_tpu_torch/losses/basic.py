"""Pixel losses (port of super_resolution_tpu/losses/basic.py; ref:
basicsr/losses/basic_loss.py).

Each loss is a small callable configured by the YAML ``type`` /
``loss_weight`` / ``reduction`` schema; tensors are NHWC.
``get_refined_artifact_map`` is the LDL weight map of the real-world GAN
runners (runtime/realgan.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from super_resolution_tpu_torch.utils.registry import LOSS_REGISTRY

_REDUCTIONS = ("none", "mean", "sum")


def _reduce(x, reduction: str):
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    return x


def l1_loss(pred, target, reduction: str = "mean"):
    return _reduce((pred - target).abs(), reduction)


def mse_loss(pred, target, reduction: str = "mean"):
    d = pred - target
    return _reduce(d * d, reduction)


def charbonnier_loss(pred, target, eps: float = 1e-12,
                     reduction: str = "mean"):
    d = pred - target
    return _reduce(torch.sqrt(d * d + eps), reduction)


class _WeightedLoss:
    def __init__(self, loss_weight: float = 1.0, reduction: str = "mean"):
        if reduction not in _REDUCTIONS:
            raise ValueError(f"Unsupported reduction: {reduction}")
        self.loss_weight = loss_weight
        self.reduction = reduction


@LOSS_REGISTRY.register()
class L1Loss(_WeightedLoss):
    def __call__(self, pred, target, weight=None):
        if weight is not None:
            return self.loss_weight * _reduce((pred - target).abs() * weight,
                                              self.reduction)
        return self.loss_weight * l1_loss(pred, target, self.reduction)


@LOSS_REGISTRY.register()
class MSELoss(_WeightedLoss):
    def __call__(self, pred, target, weight=None):
        if weight is not None:
            d = pred - target
            return self.loss_weight * _reduce(d * d * weight, self.reduction)
        return self.loss_weight * mse_loss(pred, target, self.reduction)


@LOSS_REGISTRY.register()
class CharbonnierLoss(_WeightedLoss):
    def __init__(self, loss_weight: float = 1.0, reduction: str = "mean",
                 eps: float = 1e-12):
        super().__init__(loss_weight, reduction)
        self.eps = eps

    def __call__(self, pred, target, weight=None):
        d = pred - target
        v = torch.sqrt(d * d + self.eps)
        if weight is not None:
            v = v * weight
        return self.loss_weight * _reduce(v, self.reduction)


@LOSS_REGISTRY.register()
class WeightedTVLoss(_WeightedLoss):
    """Total-variation loss (ref: basic_loss.py:118)."""

    def __call__(self, pred, weight=None):
        dy = (pred[:, 1:, :, :] - pred[:, :-1, :, :]).abs()
        dx = (pred[:, :, 1:, :] - pred[:, :, :-1, :]).abs()
        if weight is not None:
            dy = dy * weight[:, 1:, :, :]
            dx = dx * weight[:, :, 1:, :]
        return self.loss_weight * (_reduce(dy, self.reduction)
                                   + _reduce(dx, self.reduction))


def _local_variance(x, ksize: int):
    """The unbiased variance over each k x k window of the reflect-padded
    NHWC ``x`` (ref: basicsr/losses/loss_util.py::get_local_weights), from
    two box sums."""
    pad = (ksize - 1) // 2
    xp = F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="reflect")
    s = F.avg_pool2d(xp, ksize, 1, divisor_override=1)
    s2 = F.avg_pool2d(xp * xp, ksize, 1, divisor_override=1)
    n = ksize * ksize
    return ((s2 - s * s / n) / (n - 1)).permute(0, 2, 3, 1)


def get_refined_artifact_map(img_gt, img_output, img_ema, ksize: int = 7):
    """The LDL per-pixel artifact weight (Details or Artifacts, CVPR 2022;
    ref: loss_util.py::get_refined_artifact_map, realesrgan_model.py
    :222-225) on NHWC images: the channel-summed residual's per-image
    variance^(1/5) times its local variance, 0 where the output is already
    closer to the GT than the EMA network's output."""
    residual_ema = (img_gt - img_ema).abs().sum(dim=-1, keepdim=True)
    residual_sr = (img_gt - img_output).abs().sum(dim=-1, keepdim=True)
    patch = torch.var(residual_sr, dim=(1, 2, 3), keepdim=True,
                      correction=1) ** (1 / 5)
    pixel = _local_variance(residual_sr, ksize)
    return torch.where(residual_sr < residual_ema,
                       torch.zeros_like(pixel), patch * pixel)
