"""Optical-flow warping and the flow pyramids' resampling, NHWC (port of
super_resolution_tpu/ops/flow.py; ref: basicsr/archs/arch_util.py:113-146
flow_warp).

The warp samples at exactly grid + flow through
:func:`~super_resolution_tpu_torch.ops.grid_sample.bilinear_gather`, with
no round trip through normalised coordinates, as JAX does: it matches JAX
to float rounding (and ``F.grid_sample`` to a few ulps)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from super_resolution_tpu_torch.ops.grid_sample import bilinear_gather


def flow_warp(x, flow, interp_mode: str = "bilinear",
              padding_mode: str = "zeros", align_corners: bool = True):
    """Warp x (B, H, W, C) by flow (B, H, W, 2), a displacement in pixels
    with channels (dx, dy). ``align_corners`` false maps the positions
    through torch's half-pixel rule as the reference's grid_sample call
    does; ``padding_mode`` ``zeros`` or ``border``."""
    if interp_mode != "bilinear":
        raise NotImplementedError(interp_mode)
    h, w = x.shape[1], x.shape[2]
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=flow.dtype, device=flow.device),
        torch.arange(w, dtype=flow.dtype, device=flow.device), indexing="ij")
    ix = gx + flow[..., 0]
    iy = gy + flow[..., 1]
    if not align_corners:
        ix = (2.0 * ix / max(w - 1, 1) + 1.0) * 0.5 * w - 0.5
        iy = (2.0 * iy / max(h - 1, 1) + 1.0) * 0.5 * h - 0.5
    return bilinear_gather(x, ix, iy, padding_mode)


def resize_bilinear_ac(img, out_h: int, out_w: int):
    """Bilinear resize with align_corners=True (B, H, W, C) -> (B, out_h,
    out_w, C): the SpyNet pyramids' flow upsampling (ref:
    spynet_arch.py:66)."""
    h, w = img.shape[1], img.shape[2]
    kw = dict(dtype=img.dtype, device=img.device)
    ys = (torch.linspace(0.0, h - 1.0, out_h, **kw) if out_h > 1
          else torch.zeros(1, **kw))
    xs = (torch.linspace(0.0, w - 1.0, out_w, **kw) if out_w > 1
          else torch.zeros(1, **kw))
    iy, ix = torch.meshgrid(ys, xs, indexing="ij")
    return bilinear_gather(img, ix[None], iy[None], "border")


def avg_pool2(x):
    """2 x 2 stride-2 average pool, floor mode (torch ``F.avg_pool2d``)."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
