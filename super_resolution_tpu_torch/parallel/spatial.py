"""Row-sharded SR inference with a halo exchange between neighbouring ranks
(port of super_resolution_tpu/parallel/spatial.py).

The image is cut into equal row bands, one a rank of the axis; each rank
sends its top and bottom 2 * halo rows to its neighbours (one
``batch_isend_irecv``) and runs the network on a window of band + 2 * halo
rows. The border ranks have no outer neighbour, so their window extends
inward (rank 0 takes 2 * halo rows more from below, the last rank from
above): all its content is real pixels and the network zero-pads only at
true image edges, as the whole-image forward does. Each rank keeps its
band's rows of the output, and the bands are gathered, so every rank
returns the whole image. Where ``halo`` covers the network's receptive
field the result equals the unsharded forward.
"""

from __future__ import annotations

import torch

from super_resolution_tpu_torch.parallel.mesh import (all_gather_cat,
                                                      axis_rank, axis_size,
                                                      exchange)


def spatial_shard_forward(apply_fn, img: torch.Tensor, scale: int, mesh,
                          halo: int, axis: str = "data") -> torch.Tensor:
    """Row-sharded upscale of (1, H, W, C) -> (1, H * scale, W * scale, C').

    apply_fn: NHWC -> NHWC x``scale`` forward, called with one
      (band + 2 * halo)-row window a rank. ``img``: the whole image on every
      rank. H must divide by the axis size, and each band be at least
      2 * halo rows.
    """
    n = axis_size(mesh, axis)
    _, h, w, _ = img.shape
    if n == 1:
        return apply_fn(img)
    band, rem = divmod(h, n)
    if rem:
        raise ValueError(f"H={h} must divide the {axis!r} axis size {n}")
    if band < 2 * halo:
        raise ValueError(
            f"band {band} rows < 2*halo ({2 * halo}): lower halo or use "
            "fewer ranks (border windows shift inward by 2*halo)")
    group, r = mesh.get_group(axis), axis_rank(mesh, axis)
    x = img[:, r * band:(r + 1) * band].contiguous()
    spec = (x[:, :2 * halo].shape, x.dtype, x.device)
    sends, recvs = {}, {}
    if r > 0:                 # my top rows go up, the rows above come down
        sends[r - 1] = x[:, :2 * halo].contiguous()
        recvs[r - 1] = spec
    if r < n - 1:
        sends[r + 1] = x[:, -2 * halo:].contiguous()
        recvs[r + 1] = spec
    got = exchange(sends, recvs, group)
    if r == 0:
        win, off = torch.cat([x, got[1]], 1), 0
    elif r == n - 1:
        win, off = torch.cat([got[r - 1], x], 1), 2 * halo
    else:
        win, off = torch.cat([got[r - 1][:, halo:], x,
                              got[r + 1][:, :halo]], 1), halo
    out = apply_fn(win)[:, off * scale:(off + band) * scale]
    return all_gather_cat(out.contiguous(), group, dim=1)
