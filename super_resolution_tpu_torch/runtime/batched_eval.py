"""Shape-bucketed tiled evaluation across images (port of
super_resolution_tpu/runtime/batched_eval.py).

A benchmark set of many image sizes (Urban100 has about 100) runs through
a handful of fixed input shapes, with the tiles of several images batched
together:

  - each image's tile plan is the per-image engine's (runtime/tile.py,
    the same ``_axis_plan``), made over its true dims, so a gathered window
    holds real pixels only. The images of a bucket are copied once into
    one zero canvas on their device, whose padding is never read;
  - the windows are gathered from that canvas on the device by index
    operations, run through the network ``chunk`` at a time, and their
    centres pasted into an output canvas on the device in tile order (a
    later tile overwrites the overlap of an earlier one, as per image);
  - the last chunk is filled up with copies of the bucket's first tile, so
    every chunk of a bucket has one shape. The copies run through the
    network and are not pasted: the real first tile's centre is already
    in place, and pasting a copy after the later tiles would overwrite
    their pixels wherever the first centre overlaps theirs (a side under
    twice the tile size).

Bucket signature = (window shape, centre shape, canvas dims rounded up to
``quant``); images with one signature share one input shape of the
network. The result equals the per-image ``tile_forward`` with the same
plan; only the batch a tile runs in differs.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

# the contract with the per-image engine needs the same planner
from super_resolution_tpu_torch.runtime.tile import _axis_plan as _plan
from super_resolution_tpu_torch.runtime.tile import split_over_mesh


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _quant_up(dim: int, q: int) -> int:
    return -(-dim // q) * q


def group_images(shapes: Sequence[Tuple[int, int]], tile_size, tile_pad,
                 quant: int = 32) -> Dict[tuple, List[int]]:
    """Image indices grouped by bucket signature: images whose (h, w) give
    the same window and centre shapes and the same canvas dims rounded up
    to ``quant`` share one input shape. Images smaller than the padded tile
    window get a signature of their own size (the window clamps to the
    image)."""
    ts_y, ts_x = _pair(tile_size)
    tp_y, tp_x = _pair(tile_pad)
    groups: Dict[tuple, List[int]] = {}
    for i, (h, w) in enumerate(shapes):
        t_y = min(ts_y + 2 * tp_y, h)
        t_x = min(ts_x + 2 * tp_x, w)
        cs_y, cs_x = min(ts_y, h), min(ts_x, w)
        key = (t_y, t_x, cs_y, cs_x, _quant_up(h, quant), _quant_up(w, quant))
        groups.setdefault(key, []).append(i)
    return groups


def _index_grid(starts: torch.Tensor, size: int) -> torch.Tensor:
    """(N,) starts -> (N, size) indices start + 0 .. size - 1."""
    return starts[:, None] + torch.arange(size, device=starts.device)


def tile_forward_group(apply_fn: Callable, imgs: Sequence[torch.Tensor],
                       scale: int, tile_size, tile_pad, chunk: int = 8,
                       quant: int = 32, mesh=None) -> List[torch.Tensor]:
    """Tiled upscale of a group of images that share a
    :func:`group_images` signature, all chunks at one input shape.

    Args:
      apply_fn: batched NHWC -> NHWC x``scale`` forward (the runner's
        ``wrap_apply``: the cast to the inference dtype happens inside).
      imgs: (1, h_i, w_i, C) tensors on one device.
      mesh: a 1-D mesh to split each chunk over
        (``tile.split_over_mesh``); every rank returns every output.
    Returns:
      list of (1, h_i * scale, w_i * scale, C') tensors, in order.
    """
    ts_y, ts_x = _pair(tile_size)
    tp_y, tp_x = _pair(tile_pad)
    dims = [(int(im.shape[1]), int(im.shape[2])) for im in imgs]
    c = int(imgs[0].shape[3])
    device = imgs[0].device

    plans = []
    t_shape = cs_shape = None
    for h, w in dims:
        ny, t_y, cs_y, st_y, off_y, pos_y = _plan(h, ts_y, tp_y)
        nx, t_x, cs_x, st_x, off_x, pos_x = _plan(w, ts_x, tp_x)
        if t_shape is None:
            t_shape, cs_shape = (t_y, t_x), (cs_y, cs_x)
        elif (t_y, t_x) != t_shape or (cs_y, cs_x) != cs_shape:
            raise ValueError(
                "images in a tile group must share window/center shapes "
                f"(got {(t_y, t_x)} vs {t_shape}); group with group_images")
        plans.append((np.repeat(st_y, nx), np.tile(st_x, ny),
                      np.repeat(off_y, nx), np.tile(off_x, ny),
                      np.repeat(pos_y, nx), np.tile(pos_x, ny)))
    t_y, t_x = t_shape
    cs_y, cs_x = cs_shape

    sy, sx, oy, ox, py, px = (np.concatenate([p[k] for p in plans])
                              for k in range(6))
    img_idx = np.concatenate([np.full(len(p[0]), i)
                              for i, p in enumerate(plans)])
    n = len(sy)
    chunk = min(chunk, n)
    if mesh is not None:
        apply_fn, chunk = split_over_mesh(apply_fn, chunk, mesh)
    n_pad = (-n) % chunk
    if n_pad:
        sy, sx, img_idx = (np.concatenate([a, np.repeat(a[:1], n_pad)])
                           for a in (sy, sx, img_idx))

    # one zero canvas a bucket, its dims rounded up to quant, filled on the
    # images' device
    hb = _quant_up(max(h for h, _ in dims), quant)
    wb = _quant_up(max(w for _, w in dims), quant)
    canvas = torch.zeros((len(imgs), hb, wb, c), dtype=imgs[0].dtype,
                         device=device)
    for i, (im, (h, w)) in enumerate(zip(imgs, dims)):
        canvas[i, :h, :w] = im[0]
    gather_i, gather_y, gather_x = (
        torch.as_tensor(a, dtype=torch.long, device=device)
        for a in (img_idx, sy, sx))
    rows = _index_grid(gather_y, t_y)[:, :, None]
    cols = _index_grid(gather_x, t_x)[:, None, :]

    out_canvas = None
    for i0 in range(0, len(sy), chunk):
        sl = slice(i0, i0 + chunk)
        tiles = canvas[gather_i[sl, None, None], rows[sl], cols[sl]]
        out = apply_fn(tiles)
        if out_canvas is None:
            out_canvas = out.new_zeros((len(imgs), hb * scale, wb * scale,
                                        out.shape[-1]))
        for j in range(min(chunk, n - i0)):
            k = i0 + j
            out_canvas[int(img_idx[k]),
                       py[k] * scale:(py[k] + cs_y) * scale,
                       px[k] * scale:(px[k] + cs_x) * scale] = \
                out[j, oy[k] * scale:(oy[k] + cs_y) * scale,
                    ox[k] * scale:(ox[k] + cs_x) * scale]
    return [out_canvas[i:i + 1, :h * scale, :w * scale]
            for i, (h, w) in enumerate(dims)]


def bucketed_tile_eval(apply_fn: Callable, imgs: Sequence[torch.Tensor],
                       scale: int, tile_size, tile_pad, chunk: int = 8,
                       quant: int = 32, mesh=None) -> List[torch.Tensor]:
    """Tiled upscale of a varied-size image list: grouped by signature
    (:func:`group_images`), each group through :func:`tile_forward_group`;
    the results in input order."""
    shapes = [(int(im.shape[1]), int(im.shape[2])) for im in imgs]
    groups = group_images(shapes, tile_size, tile_pad, quant)
    results: List = [None] * len(imgs)
    for idxs in groups.values():
        outs = tile_forward_group(apply_fn, [imgs[i] for i in idxs], scale,
                                  tile_size, tile_pad, chunk, quant, mesh)
        for i, o in zip(idxs, outs):
            results[i] = o
    return results
