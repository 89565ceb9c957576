"""VGG perceptual and style loss (port of super_resolution_tpu/losses/
perceptual.py; ref: basicsr/losses/basic_loss.py PerceptualLoss).

The VGG19 weights come from ``vgg_weights_path``, a torchvision vgg19 .pth
(``features.N.weight`` / ``.bias``); without it the loss raises, as the JAX
package's does: nothing is downloaded. The network is frozen, and the GT's
features carry no gradient.
"""

from __future__ import annotations

from typing import Dict

import torch

from super_resolution_tpu_torch.models.vgg_arch import VGGFeatureExtractor
from super_resolution_tpu_torch.utils.registry import LOSS_REGISTRY


def _gram(feat):
    """(B, C, H, W) -> (B, C, C) / (C H W)."""
    b, c, h, w = feat.shape
    f = feat.reshape(b, c, h * w)
    return f @ f.transpose(1, 2) / (h * w * c)


@LOSS_REGISTRY.register()
class PerceptualLoss:
    """``__call__(x, gt)`` on NHWC RGB returns (perceptual, style), each
    None where its weight is 0. ``to(device)`` moves the VGG."""

    def __init__(self, layer_weights: Dict[str, float],
                 vgg_type: str = "vgg19", use_input_norm: bool = True,
                 range_norm: bool = False, perceptual_weight: float = 1.0,
                 style_weight: float = 0.0, criterion: str = "l1",
                 vgg_weights_path: str | None = None):
        if vgg_type != "vgg19":
            raise NotImplementedError("only vgg19 is supported")
        if criterion not in ("l1", "l2", "mse", "fro"):
            raise NotImplementedError(criterion)
        self.layer_weights = layer_weights
        self.perceptual_weight = perceptual_weight
        self.style_weight = style_weight
        self.criterion = criterion
        if vgg_weights_path is None:
            raise ValueError(
                "PerceptualLoss needs vgg_weights_path (a torchvision vgg19 "
                ".pth); no weights are downloaded.")
        self.net = VGGFeatureExtractor(tuple(layer_weights),
                                       use_input_norm=use_input_norm,
                                       range_norm=range_norm)
        self.net.load_torchvision(torch.load(vgg_weights_path,
                                             map_location="cpu",
                                             weights_only=True))
        self.net.eval().requires_grad_(False)

    def to(self, device) -> "PerceptualLoss":
        self.net.to(device)
        return self

    def _dist(self, a, b):
        if self.criterion == "l1":
            return (a - b).abs().mean()
        if self.criterion in ("l2", "mse"):
            return ((a - b) ** 2).mean()
        return torch.linalg.vector_norm(a - b)

    def __call__(self, x, gt):
        fx = self.net(x)
        with torch.no_grad():
            fg = self.net(gt.detach())
        percep = style = None
        if self.perceptual_weight > 0:
            percep = sum(self._dist(fx[k], fg[k]) * w
                         for k, w in self.layer_weights.items())
            percep = percep * self.perceptual_weight
        if self.style_weight > 0:
            style = sum(self._dist(_gram(fx[k]), _gram(fg[k])) * w
                        for k, w in self.layer_weights.items())
            style = style * self.style_weight
        return percep, style
