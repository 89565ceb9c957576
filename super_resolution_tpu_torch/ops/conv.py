"""Convolution helpers on NHWC tensors (port of
super_resolution_tpu/ops/conv.py).

Filters keep torch's OIHW layout, so checkpoints load as they are. Each
helper runs ``F.conv2d`` on ``x.permute(0, 3, 1, 2)``, a channels_last view
of the NHWC activation, and permutes the result back.

The JAX package also has a space-to-depth lowering of the small-channel
large-kernel conv (``conv2d_nhwc_s2d``): a rewrite for the TPU's matrix
unit that equals the plain conv. The port's large-kernel conv is
:func:`conv2d_nhwc`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d_nhwc(x, kernel_oihw, bias=None, stride: int = 1, padding=None,
                groups: int = 1, dilation: int = 1):
    """NHWC conv with an (O, I/g, kh, kw) filter; same padding by default."""
    kh, kw = kernel_oihw.shape[2], kernel_oihw.shape[3]
    if padding is None:
        padding = (kh // 2, kw // 2)
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel_oihw, bias, stride, padding,
                 dilation, groups)
    return y.permute(0, 2, 3, 1)


def depthwise_conv_nhwc(x, kernel_hwc, bias=None, padding=None):
    """Depthwise conv: filter (kh, kw, C), one plane per channel."""
    c = kernel_hwc.shape[-1]
    return conv2d_nhwc(x, kernel_hwc.permute(2, 0, 1)[:, None], bias,
                       padding=padding, groups=c)


def dynamic_depthwise_conv(x, kernels):
    """Per-sample depthwise conv for any odd k, zero padding.

    x: (B, H, W, C); kernels: (B, k, k, C). Sample b's channel c is
    cross-correlated with kernels[b, :, :, c]. The batch goes into the conv
    groups: one grouped conv with B * C groups on a (1, B * C, H, W) tensor.
    """
    b, h, w, c = x.shape
    k = kernels.shape[1]
    xg = x.permute(0, 3, 1, 2).reshape(1, b * c, h, w)
    kg = kernels.permute(0, 3, 1, 2).reshape(b * c, 1, k, k)
    out = F.conv2d(xg, kg, None, 1, k // 2, 1, b * c)
    return out.reshape(b, c, h, w).permute(0, 2, 3, 1)


def dynamic_depthwise_conv3x3(x, kernels):
    """:func:`dynamic_depthwise_conv` for (B, 3, 3, C) kernels."""
    if tuple(kernels.shape[1:3]) != (3, 3):
        raise ValueError(f"kernels must be (B, 3, 3, C), got "
                         f"{tuple(kernels.shape)}")
    return dynamic_depthwise_conv(x, kernels)


def shifted_neighborhoods(x, k: int, mode: str = "zero"):
    """The k * k shifted copies of x stacked: (B, H, W, C) -> (B, H, W,
    k * k, C), the taps in row-major (dy, dx) order over the window, as a
    conv filter flattened as (kh, kw). ``mode``: ``zero`` pads with zeros,
    any other mode is ``F.pad``'s (``reflect``, ``replicate``)."""
    pad = k // 2
    xp = F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad),
               mode="constant" if mode == "zero" else mode)
    xp = xp.permute(0, 2, 3, 1)
    h, w = x.shape[1], x.shape[2]
    return torch.stack([xp[:, dy:dy + h, dx:dx + w, :]
                        for dy in range(k) for dx in range(k)], dim=3)
