"""Bilinear sampling on NHWC tensors (port of
super_resolution_tpu/ops/grid_sample.py).

:func:`grid_sample_bilinear` takes normalised coordinates and is
``torch.nn.functional.grid_sample``. :func:`bilinear_gather` takes pixel
positions and is JAX's ``_bilinear_gather``: four gathers and a lerp in
its order of operations, so that the flow warp and the deformable
convolution built on it (``ops/flow.py``, ``ops/deform_conv.py``) agree
with JAX to float rounding."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_bilinear(img, grid, align_corners: bool = False,
                         padding_mode: str = "border"):
    """img: (B, H, W, C); grid: (B, Ho, Wo, 2), normalised (x, y) in
    [-1, 1]; padding_mode ``border`` or ``zeros``. Returns (B, Ho, Wo, C)
    in img's dtype."""
    if padding_mode not in ("border", "zeros"):
        raise NotImplementedError(padding_mode)
    out = F.grid_sample(img.permute(0, 3, 1, 2), grid.to(img.dtype),
                        mode="bilinear", padding_mode=padding_mode,
                        align_corners=align_corners)
    return out.permute(0, 2, 3, 1)


def bilinear_gather(img, ix, iy, padding_mode: str = "border"):
    """Sample img (B, H, W, C) bilinearly at the pixel positions ix, iy
    (shape (B, ...) or (1, ...), broadcast over the batch). Returns
    (B, ..., C). ``zeros``: a corner tap outside the image counts 0 (torch
    grid_sample's rule); ``border``: positions are clamped to the edge."""
    if padding_mode not in ("border", "zeros"):
        raise NotImplementedError(padding_mode)
    b, h, w, c = img.shape
    spatial = ix.shape[1:]
    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    fx = (ix - x0).unsqueeze(-1)
    fy = (iy - y0).unsqueeze(-1)
    x0i, y0i = x0.long(), y0.long()
    x1i, y1i = x0i + 1, y0i + 1
    flat = img.reshape(b, h * w, c)
    bidx = torch.arange(b, device=img.device).reshape(b, 1)

    def tap(yi, xi):
        lin = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(
            yi.shape[0], -1)
        v = flat[bidx, lin]
        if padding_mode == "zeros":
            ok = ((yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1))
            v = v * ok.reshape(ok.shape[0], -1, 1).to(img.dtype)
        return v.reshape((b,) + tuple(spatial) + (c,))

    v00, v01 = tap(y0i, x0i), tap(y0i, x1i)
    v10, v11 = tap(y1i, x0i), tap(y1i, x1i)
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy
