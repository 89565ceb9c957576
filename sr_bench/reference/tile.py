"""The reference's own request path: reflect pad to a window multiple, the
tile plan of the cell's tile settings, paste, crop.

The tile plan is the one the option files' ``tile:`` block defines: along
each axis n = ceil(dim / tile) tiles, each a window of T = min(tile + 2 *
pad, dim) pixels that slides inward at the borders, whose centre block of
min(tile, dim) pixels is pasted at p_i = min(i * tile, dim - min(tile,
dim)). Without tile settings the whole padded image is one forward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def axis_plan(dim: int, tile: int, pad: int):
    """[(window start, centre offset in the window, centre position)] and
    (window size, centre size) along one axis."""
    n = max(1, -(-dim // tile))
    t, cs = min(tile + 2 * pad, dim), min(tile, dim)
    plan = []
    for i in range(n):
        pos = min(i * tile, dim - cs)
        start = min(max(pos - pad, 0), dim - t)
        plan.append((start, pos - start, pos))
    return plan, t, cs


def forward_shapes(h: int, w: int, ws: int, tile: dict | None) -> list:
    """(batch, height, width) of each forward of a request of LR size (h, w):
    the padded image, or the tile plan's chunks of ``tile['chunk']``."""
    hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
    if not tile:
        return [(1, hp, wp)]
    py, ty, _ = axis_plan(hp, tile["tile_size"], tile["tile_pad"])
    px, tx, _ = axis_plan(wp, tile["tile_size"], tile["tile_pad"])
    n, chunk = len(py) * len(px), tile["chunk"]
    return [(min(chunk, n - i), ty, tx) for i in range(0, n, chunk)]


def upscale(forward, lq: torch.Tensor, scale: int, ws: int,
            tile: dict | None, block: int = 4) -> torch.Tensor:
    """(H, W, C) float32 LR on the reference's device -> (H * scale, W *
    scale, C): pad, forward (tiled, ``block`` tiles a call), crop.
    ``forward`` maps an NHWC batch to its upscaled NHWC batch."""
    h, w, _ = lq.shape
    ph, pw = (-h) % ws, (-w) % ws
    img = F.pad(lq.permute(2, 0, 1)[None], (0, pw, 0, ph), mode="reflect")
    img = img.permute(0, 2, 3, 1)[0]
    hp, wp = img.shape[0], img.shape[1]
    if not tile:
        out = forward(img[None])[0]
    else:
        py, ty, cy = axis_plan(hp, tile["tile_size"], tile["tile_pad"])
        px, tx, cx = axis_plan(wp, tile["tile_size"], tile["tile_pad"])
        steps = [(a, b) for a in py for b in px]
        out = None
        for i in range(0, len(steps), block):
            part = steps[i:i + block]
            res = forward(torch.stack([img[ys:ys + ty, xs:xs + tx]
                                       for (ys, _, _), (xs, _, _) in part]))
            if out is None:
                out = res.new_zeros((hp * scale, wp * scale, res.shape[-1]))
            for r, ((_, oy, y), (_, ox, x)) in zip(res, part):
                out[y * scale:(y + cy) * scale, x * scale:(x + cx) * scale] = \
                    r[oy * scale:(oy + cy) * scale, ox * scale:(ox + cx) * scale]
    return out[:h * scale, :w * scale]
