"""Pixel shuffle and unshuffle in NHWC with torch's channel order: input
channel ``c * r^2 + i * r + j`` goes to output channel ``c`` at offset
(i, j), so conv weights from torch checkpoints keep their output-channel
order."""

from __future__ import annotations


def pixel_shuffle(x, r: int):
    """(B, H, W, C * r^2) -> (B, H * r, W * r, C)."""
    b, h, w, crr = x.shape
    c = crr // (r * r)
    x = x.reshape(b, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)  # b h i w j c
    return x.reshape(b, h * r, w * r, c)


def pixel_unshuffle(x, r: int):
    """(B, H * r, W * r, C) -> (B, H, W, C * r^2), the inverse of
    :func:`pixel_shuffle`."""
    b, hr, wr, c = x.shape
    h, w = hr // r, wr // r
    x = x.reshape(b, h, r, w, r, c).permute(0, 1, 3, 5, 2, 4)  # b h w c i j
    return x.reshape(b, h, w, c * r * r)
