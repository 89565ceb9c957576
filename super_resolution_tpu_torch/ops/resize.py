"""Image resize on NHWC tensors (port of ``resize_to`` of
super_resolution_tpu/ops/degrade.py).

The JAX function reproduces ``torch.nn.functional.interpolate`` with
``align_corners=False`` (``area``: adaptive average pooling) as two
gather-contractions; here it is that call, on the NCHW view.
"""

from __future__ import annotations

import torch.nn.functional as F

MODES = ("bicubic", "bilinear", "area", "nearest")


def resize_to(img, out_h: int, out_w: int, mode: str):
    """(B, H, W, C) -> (B, out_h, out_w, C) in img's dtype, interpolated in
    float32 (bicubic: A = -0.75, the border replicated)."""
    if mode not in MODES:
        raise ValueError(f"Unknown resize mode {mode}")
    kw = {} if mode in ("area", "nearest") else dict(align_corners=False)
    y = F.interpolate(img.permute(0, 3, 1, 2).float(), size=(out_h, out_w),
                      mode=mode, **kw)
    return y.permute(0, 2, 3, 1).to(img.dtype)
