"""Window partition and reverse, and overlapping-window extraction, NHWC
(port of super_resolution_tpu/ops/windowing.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def window_partition(x, window_size: int):
    """(B, H, W, C) -> (B * nWh * nWw, ws, ws, C); ws must divide H and W."""
    b, h, w, c = x.shape
    ws = window_size
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, c)


def window_reverse(windows, window_size: int, h: int, w: int):
    """Inverse of :func:`window_partition`."""
    ws = window_size
    b = windows.shape[0] // (h * w // ws // ws)
    x = windows.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def extract_overlap_windows(x, window_size: int, overlap_win_size: int):
    """Zero-padded overlapping windows for OCAB keys and values, the NHWC
    equivalent of ``nn.Unfold(kernel_size=ow, stride=ws,
    padding=(ow - ws) // 2)``.

    x: (B, H, W, C), H and W multiples of window_size.
    Returns (B * nWh * nWw, ow * ow, C).
    """
    b, h, w, c = x.shape
    ws, ow = window_size, overlap_win_size
    pad = (ow - ws) // 2
    nh, nw = h // ws, w // ws
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    ar = torch.arange(ow, device=x.device)
    idx_h = torch.arange(nh, device=x.device)[:, None] * ws + ar[None, :]
    idx_w = torch.arange(nw, device=x.device)[:, None] * ws + ar[None, :]
    rows = xp[:, idx_h]                  # (B, nH, ow, W + 2p, C)
    patches = rows[:, :, :, idx_w]       # (B, nH, ow, nW, ow, C)
    patches = patches.permute(0, 1, 3, 2, 4, 5)
    return patches.reshape(b * nh * nw, ow * ow, c)


def reflect_pad(x, pad_h: int, pad_w: int):
    """Pad NHWC H and W at the bottom and the right with their mirror image
    (the edge not repeated), as often as the pad needs: numpy's and
    ``jnp.pad``'s ``reflect`` mode, which ``F.pad`` takes only for a pad
    shorter than the side. A side of one is repeated."""
    for dim, pad in ((1, pad_h), (2, pad_w)):
        if pad:
            n = x.shape[dim]
            i = torch.arange(n + pad, device=x.device)
            if n > 1:
                i = i % (2 * n - 2)
                i = torch.where(i < n, i, 2 * n - 2 - i)
            else:
                i = torch.zeros_like(i)
            x = x.index_select(dim, i)
    return x


def pad_to_multiple(x, multiple: int):
    """Reflect-pad NHWC H and W up to the next multiple (:func:`reflect_pad`).
    Returns (padded, (pad_h, pad_w))."""
    h, w = x.shape[1], x.shape[2]
    pad_h = (multiple - h % multiple) % multiple
    pad_w = (multiple - w % multiple) % multiple
    if pad_h or pad_w:
        x = reflect_pad(x, pad_h, pad_w).contiguous()
    return x, (pad_h, pad_w)
