"""StyleGAN2 generator with plain interpolation for every resampling (port
of super_resolution_tpu/models/stylegan2_bilinear_arch.py; ref:
basicsr/archs/stylegan2_bilinear_arch.py:11-463): the modulated conv
interpolates its input x2 (``F.interpolate``, ``align_corners=False``, the
JAX package's ``resize_to``) and convolves it, and the RGB skip is
interpolated too; no FIR smoothing. Names, buffers, the NHWC output and
``forward`` are :class:`~super_resolution_tpu_torch.models.stylegan2_arch.
StyleGAN2Generator`'s.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from super_resolution_tpu_torch.models.stylegan2_arch import (
    ModulatedConv2d, StyleConv, ToRGB, _StyleGeneratorBase)
from super_resolution_tpu_torch.utils.registry import ARCH_REGISTRY


def interpolate(x, out_h: int, out_w: int, mode: str):
    """NCHW resize as ``F.interpolate`` (``align_corners=False`` where the
    mode takes it)."""
    kw = {} if mode in ("area", "nearest") else dict(align_corners=False)
    return F.interpolate(x, size=(out_h, out_w), mode=mode, **kw)


class ModulatedConv2dBilinear(ModulatedConv2d):
    """(ref: stylegan2_bilinear_arch.py:73-160)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 num_style_feat: int, demodulate: bool = True,
                 sample_mode: str | None = None, eps: float = 1e-8,
                 interpolation_mode: str = "bilinear"):
        super().__init__(in_channels, out_channels, kernel_size,
                         num_style_feat, demodulate, None, eps=eps)
        self.resize_mode = sample_mode
        self.interpolation_mode = interpolation_mode

    def forward(self, x, style):
        h, w = x.shape[2], x.shape[3]
        if self.resize_mode == "upsample":
            x = interpolate(x, h * 2, w * 2, self.interpolation_mode)
        elif self.resize_mode == "downsample":
            x = interpolate(x, h // 2, w // 2, self.interpolation_mode)
        return super().forward(x, style)


class StyleConvBilinear(StyleConv):
    """(ref: stylegan2_bilinear_arch.py:163-207)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 num_style_feat: int, demodulate: bool = True,
                 sample_mode: str | None = None,
                 interpolation_mode: str = "bilinear"):
        super().__init__(in_channels, out_channels, kernel_size,
                         num_style_feat, demodulate)
        self.modulated_conv = ModulatedConv2dBilinear(
            in_channels, out_channels, kernel_size, num_style_feat,
            demodulate, sample_mode, interpolation_mode=interpolation_mode)


class ToRGBBilinear(ToRGB):
    """(ref: stylegan2_bilinear_arch.py:209-254)."""

    def __init__(self, in_channels: int, num_style_feat: int,
                 upsample: bool = True, interpolation_mode: str = "bilinear"):
        super().__init__(in_channels, num_style_feat, upsample)
        self.interpolation_mode = interpolation_mode

    def resample_skip(self, skip):
        return interpolate(skip, skip.shape[2] * 2, skip.shape[3] * 2,
                           self.interpolation_mode)


@ARCH_REGISTRY.register()
class StyleGAN2GeneratorBilinear(_StyleGeneratorBase):
    """(ref: stylegan2_bilinear_arch.py:274-463)."""

    def __init__(self, out_size: int, num_style_feat: int = 512,
                 num_mlp: int = 8, channel_multiplier: int = 2,
                 lr_mlp: float = 0.01, narrow: float = 1.0,
                 interpolation_mode: str = "bilinear"):
        super().__init__(out_size, num_style_feat, num_mlp,
                         channel_multiplier, lr_mlp, narrow)
        ch, mode = self.channels, interpolation_mode
        self.style_conv1 = StyleConvBilinear(ch["4"], ch["4"], 3,
                                             num_style_feat,
                                             interpolation_mode=mode)
        self.to_rgb1 = ToRGBBilinear(ch["4"], num_style_feat, upsample=False,
                                     interpolation_mode=mode)
        self.style_convs = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        in_channels = ch["4"]
        for i in range(3, self.log_size + 1):
            out_channels = ch[f"{2 ** i}"]
            self.style_convs.append(StyleConvBilinear(
                in_channels, out_channels, 3, num_style_feat,
                sample_mode="upsample", interpolation_mode=mode))
            self.style_convs.append(StyleConvBilinear(
                out_channels, out_channels, 3, num_style_feat,
                interpolation_mode=mode))
            self.to_rgbs.append(ToRGBBilinear(out_channels, num_style_feat,
                                              interpolation_mode=mode))
            in_channels = out_channels
