"""Tiled inference (port of super_resolution_tpu/runtime/tile.py).

The same static plan as the JAX engine: every tile window has one size
T = min(tile + 2 * pad, dim) and slides inward at the borders
(start = clip(center - pad, 0, dim - T)), so all its content is real
pixels and the network zero-pads only at true image edges; each tile
pastes a fixed-size centre block at p_i = min(i * tile, dim - tile). The
tiles run through the network in batches of ``chunk``, one Python loop
step per batch.

With a ``mesh`` (multi-rank tiled inference) the chunk is rounded to a
multiple of the ranks, the tiles padded to whole chunks with copies of the
first (run, not pasted), each rank upscales its equal part of a chunk and
the parts are gathered: every rank returns the whole image.
"""

from __future__ import annotations

import numpy as np
import torch


def _axis_plan(dim: int, tile_size: int, tile_pad: int):
    """(n_tiles, window_size, center_size, window_starts,
    center_offsets_in_window, canvas_positions) for one axis."""
    n = max(1, -(-dim // tile_size))
    t = min(tile_size + 2 * tile_pad, dim)
    cs = min(tile_size, dim)
    pos = np.minimum(np.arange(n) * tile_size, max(dim - cs, 0))
    starts = np.clip(pos - tile_pad, 0, dim - t)
    offsets = pos - starts
    return n, t, cs, starts, offsets, pos


def split_over_mesh(apply_fn, chunk: int, mesh):
    """(apply_fn run on this rank's part of a chunk and the parts gathered,
    the chunk rounded to a multiple of the mesh's ranks: at least one tile
    a rank, JAX ``tile.py:87-91``)."""
    from super_resolution_tpu_torch.parallel.mesh import shard_apply

    group, n = mesh.get_group(), mesh.size()
    return (lambda t: shard_apply(apply_fn, t, group),
            max(chunk, n) // n * n)


def tile_forward(apply_fn, img, scale: int, tile_size, tile_pad,
                 chunk: int = 8, mesh=None):
    """Tiled upscale of (1, H, W, C) -> (1, H * scale, W * scale, C').

    apply_fn: batched NHWC -> NHWC x``scale`` network forward.
    tile_size, tile_pad: int, or (y, x) pairs for rectangular tiles.
    chunk: tiles per forward.
    mesh: a 1-D mesh to split each chunk over (the module docstring).
    """
    _, h, w, _ = img.shape
    ts_y, ts_x = (tile_size if isinstance(tile_size, (tuple, list))
                  else (tile_size, tile_size))
    tp_y, tp_x = (tile_pad if isinstance(tile_pad, (tuple, list))
                  else (tile_pad, tile_pad))
    ny, t_y, cs_y, st_y, off_y, pos_y = _axis_plan(h, ts_y, tp_y)
    nx, t_x, cs_x, st_x, off_x, pos_x = _axis_plan(w, ts_x, tp_x)
    plan = list(zip(np.repeat(st_y, nx).tolist(), np.tile(st_x, ny).tolist(),
                    np.repeat(off_y, nx).tolist(), np.tile(off_x, ny).tolist(),
                    np.repeat(pos_y, nx).tolist(), np.tile(pos_x, ny).tolist()))
    n_real = len(plan)
    if mesh is not None:
        apply_fn, chunk = split_over_mesh(apply_fn, chunk, mesh)
        plan += plan[:1] * ((-n_real) % chunk)
    canvas = None
    for i0 in range(0, len(plan), chunk):
        steps = plan[i0:i0 + chunk]
        tiles = [img[0, y0:y0 + t_y, x0:x0 + t_x] for y0, x0, *_ in steps]
        out = apply_fn(torch.stack(tiles))
        if canvas is None:
            canvas = out.new_zeros((h * scale, w * scale, out.shape[-1]))
        for tile_out, (_, _, oy, ox, py, px) in zip(
                out, steps[:n_real - i0]):
            canvas[py * scale:(py + cs_y) * scale,
                   px * scale:(px + cs_x) * scale] = \
                tile_out[oy * scale:(oy + cs_y) * scale,
                         ox * scale:(ox + cs_x) * scale]
    return canvas[None]
