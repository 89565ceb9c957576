"""Color-space conversions with MATLAB/BT.601 parity (a copy of
super_resolution_tpu/utils/color.py, its jax variant as ``rgb_to_y_pt``).

Matches the reference's conventions exactly (ref:
HAT/ESC/basicsr/utils/color_util.py — rgb2ycbcr at :5, bgr2ycbcr at :38,
rgb2ycbcr_pt at :186): ITU-R BT.601 studio-swing, *not* the JPEG variant
cv2 uses. uint8 inputs stay in [0,255]; float inputs are treated as [0,1]
and returned in the same range.
"""

from __future__ import annotations

import numpy as np

# BT.601 RGB -> Y weights (studio swing, 255-scaled).
_Y_WEIGHT_RGB = np.array([65.481, 128.553, 24.966])
_YCBCR_MAT_RGB = np.array([
    [65.481, -37.797, 112.0],
    [128.553, -74.203, -93.786],
    [24.966, 112.0, -18.214],
])
_YCBCR_OFFSET = np.array([16.0, 128.0, 128.0])


def _to_float01(img: np.ndarray) -> tuple[np.ndarray, np.dtype]:
    dtype = img.dtype
    img = img.astype(np.float32)
    if dtype != np.uint8:
        if img.max() > 1.01:
            raise ValueError("float images should be in [0, 1]")
    else:
        img = img / 255.0
    return img, dtype


def _from_float255(img: np.ndarray, dtype: np.dtype) -> np.ndarray:
    if dtype == np.uint8:
        return img.round().astype(np.uint8)
    return (img / 255.0).astype(np.float32)


def rgb2ycbcr(img: np.ndarray, y_only: bool = False) -> np.ndarray:
    """MATLAB-compatible RGB -> YCbCr (HWC numpy)."""
    img01, dtype = _to_float01(img)
    if y_only:
        out = img01 @ _Y_WEIGHT_RGB + 16.0
    else:
        out = img01 @ _YCBCR_MAT_RGB + _YCBCR_OFFSET
    return _from_float255(out, dtype)


def bgr2ycbcr(img: np.ndarray, y_only: bool = False) -> np.ndarray:
    """MATLAB-compatible BGR -> YCbCr (HWC numpy)."""
    img01, dtype = _to_float01(img)
    if y_only:
        out = img01 @ _Y_WEIGHT_RGB[::-1] + 16.0
    else:
        out = img01 @ _YCBCR_MAT_RGB[::-1] + _YCBCR_OFFSET
    return _from_float255(out, dtype)


def ycbcr2rgb(img: np.ndarray) -> np.ndarray:
    """MATLAB-compatible YCbCr -> RGB (HWC numpy)."""
    img01, dtype = _to_float01(img)
    img255 = img01 * 255.0
    rgb01 = (img255 - _YCBCR_OFFSET) @ np.linalg.inv(_YCBCR_MAT_RGB)
    return _from_float255(rgb01 * 255.0, dtype)


def to_y_channel(img: np.ndarray) -> np.ndarray:
    """BGR uint8-range HWC -> Y channel in [0, 255] float (no rounding).

    Mirrors the reference's metric preprocessing
    (ref: HAT/ESC/basicsr/metrics/metric_util.py::to_y_channel): images are
    in BGR order (cv2 convention), scaled to [0,1], converted, rescaled.
    """
    img = img.astype(np.float32) / 255.0
    if img.ndim == 3 and img.shape[2] == 3:
        img = bgr2ycbcr(img, y_only=True)
        img = img[..., None]
    return img * 255.0


def rgb_to_y_pt(img):
    """Batched RGB [0, 1] NHWC tensor -> Y [0, 1] NHW1, on the tensor's
    device (JAX ``utils/color.py::rgb_to_y_jnp``; ref: color_util.py:186-205,
    ``rgb2ycbcr_pt(y_only=True)``)."""
    import torch

    w = torch.as_tensor(_Y_WEIGHT_RGB, dtype=img.dtype, device=img.device)
    y = img @ w + 16.0
    return y[..., None] / 255.0
