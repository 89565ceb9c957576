"""Optical-flow (de)quantization (a copy of super_resolution_tpu/utils/
flow_util.py, which is numpy only; ref: basicsr/utils/flow_util.py).

The REDS dataset stores precomputed flows as stacked uint8 grayscale
images; these helpers round-trip them (numpy, host side).
"""

from __future__ import annotations

import numpy as np


def quantize(arr, min_val, max_val, levels, dtype=np.int64):
    """(ref: flow_util.py:126-150)."""
    arr = np.clip(arr, min_val, max_val)
    quantized = np.minimum(
        np.floor((arr - min_val) / (max_val - min_val) * levels).astype(dtype),
        levels - 1)
    return quantized


def dequantize(arr, min_val, max_val, levels, dtype=np.float64):
    """(ref: flow_util.py:153-175)."""
    return (arr.astype(dtype) + 0.5) * (max_val - min_val) / levels + min_val


def quantize_flow(flow, max_val: float = 0.02, norm: bool = True):
    """Quantize (h, w, 2) flow to two uint8 maps (ref: flow_util.py:76-99)."""
    h, w, _ = flow.shape
    dx = flow[..., 0]
    dy = flow[..., 1]
    if norm:
        dx = dx / w
        dy = dy / h
    return tuple(quantize(d, -max_val, max_val, 255, np.uint8)
                 for d in (dx, dy))


def dequantize_flow(dx, dy, max_val: float = 0.02, denorm: bool = True):
    """Recover flow from quantized maps (ref: flow_util.py:102-123)."""
    assert dx.shape == dy.shape
    dx, dy = (dequantize(d, -max_val, max_val, 255) for d in (dx, dy))
    if denorm:
        dx = dx * dx.shape[1]
        dy = dy * dy.shape[0]
    return np.dstack((dx, dy))
