"""Pixel losses (port of super_resolution_tpu/losses/basic.py; ref:
basicsr/losses/basic_loss.py).

Each loss is a small callable configured by the YAML ``type`` /
``loss_weight`` / ``reduction`` schema; tensors are NHWC. The LDL artifact
map (``get_refined_artifact_map``) belongs to the GAN runners and is not
ported."""

from __future__ import annotations

import torch

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
