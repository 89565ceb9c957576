"""MATLAB-compatible bicubic ``imresize`` (a copy of
super_resolution_tpu/utils/matlab.py without its jax variant).

Bit-parity with MATLAB's imresize is the backbone of SR evaluation: LR inputs
and published PSNR numbers all assume it. The reference carries a scalar-loop
torch port (ref: HAT/ESC/basicsr/utils/matlab_functions.py:6-178); here the
same math is expressed as two dense gather-matmuls in numpy.

Algorithm (per axis):
  - output coord u = (x + 0.5)/scale - 0.5 maps to input space
    (using MATLAB 1-based convention: u = x/scale + 0.5*(1 - 1/scale))
  - each output pixel gathers ceil(kw)+2 taps around u with cubic weights
    (antialiased by widening the kernel when downscaling)
  - out-of-range taps use symmetric (reflect-without-repeat) padding
"""

from __future__ import annotations

import math

import numpy as np


def _cubic(x: np.ndarray) -> np.ndarray:
    ax = np.abs(x)
    ax2, ax3 = ax * ax, ax * ax * ax
    return ((1.5 * ax3 - 2.5 * ax2 + 1.0) * (ax <= 1)
            + (-0.5 * ax3 + 2.5 * ax2 - 4.0 * ax + 2.0) * ((ax > 1) & (ax <= 2)))


def resize_weights_indices(in_length: int, out_length: int, scale: float,
                           antialiasing: bool = True):
    """Per-output-pixel tap weights and (clipped, symmetric-padded) indices.

    Returns (weights [out, taps], indices [out, taps]) where indices address
    the *unpadded* input after symmetric reflection has been applied, i.e.
    they are valid gather indices into the original axis.
    """
    kernel_width = 4.0
    if scale < 1 and antialiasing:
        kernel_width = kernel_width / scale

    x = np.arange(1, out_length + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    p = int(math.ceil(kernel_width)) + 2

    indices = left[:, None] + np.arange(p, dtype=np.float64)[None, :]
    dist = u[:, None] - indices
    if scale < 1 and antialiasing:
        weights = scale * _cubic(dist * scale)
    else:
        weights = _cubic(dist)
    weights = weights / weights.sum(axis=1, keepdims=True)

    # Trim all-zero boundary columns (mirror of the reference's narrow logic,
    # ref: matlab_functions.py:70-76).
    zero_cols = (weights == 0).sum(axis=0)
    if not math.isclose(zero_cols[0], 0, rel_tol=1e-6):
        indices = indices[:, 1:p - 1]
        weights = weights[:, 1:p - 1]
    if not math.isclose(zero_cols[-1], 0, rel_tol=1e-6):
        indices = indices[:, 0:p - 2]
        weights = weights[:, 0:p - 2]

    # Fold symmetric padding into the index map so we can gather directly
    # from the unpadded input: symmetric reflection (edge pixel repeated)
    # maps 1-based index i<1 -> 1-i and i>n -> 2n+1-i, applied once (taps
    # never exceed one reflection for the scales used in SR).
    idx = indices.astype(np.int64)
    idx = np.where(idx < 1, 1 - idx, idx)
    idx = np.where(idx > in_length, 2 * in_length + 1 - idx, idx)
    idx = idx - 1  # to 0-based
    return weights.astype(np.float64), idx


def imresize(img: np.ndarray, scale: float, antialiasing: bool = True) -> np.ndarray:
    """MATLAB-compatible bicubic resize of an HWC (or HW) [0,1] numpy image.

    Matches the reference implementation (matlab_functions.py:85-178) to
    float precision; output shape is (ceil(H*scale), ceil(W*scale), C).
    """
    squeeze = False
    if img.ndim == 2:
        img = img[:, :, None]
        squeeze = True
    in_h, in_w = img.shape[:2]
    out_h, out_w = math.ceil(in_h * scale), math.ceil(in_w * scale)

    wh, ih = resize_weights_indices(in_h, out_h, scale, antialiasing)
    ww, iw = resize_weights_indices(in_w, out_w, scale, antialiasing)

    x = img.astype(np.float64)
    # H axis: gather (out_h, taps) rows -> (out_h, taps, W, C), contract taps.
    x = np.einsum('otwc,ot->owc', x[ih], wh)
    # W axis.
    x = np.einsum('hotc,ot->hoc', x[:, iw], ww)
    out = x.astype(np.float32)
    return out[:, :, 0] if squeeze else out
