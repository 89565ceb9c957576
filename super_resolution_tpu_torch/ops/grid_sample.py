"""Bilinear grid sampling on NHWC tensors (port of
super_resolution_tpu/ops/grid_sample.py, which reproduces
``torch.nn.functional.grid_sample``; here it is that call)."""

from __future__ import annotations

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
