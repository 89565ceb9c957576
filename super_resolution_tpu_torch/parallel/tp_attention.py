"""Head-parallel fused window attention: tensor parallelism composed with
the attention kernels (port of super_resolution_tpu/parallel/
tp_attention.py).

Each rank of the ``model`` axis

  1. slices its head group's columns out of the replicated in-projection
     (the q, k and v column blocks ``g * C + r * c_loc`` of heads
     [r * H / P, (r + 1) * H / P)), the matching rows of the out-projection
     and the bias heads,
  2. runs the unchanged kernel (``fused_msa_block(_shifted)``,
     ``fused_ocab_block``) on its slice, the output bias left out,
  3. all-reduces the partials over ``model`` and adds the output bias once.

Weights stay replicated; FLOPs and the attention working set split P ways.
Autograd: the replicated inputs enter through ``mesh.copy_to_group``
(identity forward, all-reduce backward), so the gradient of x and of the
whole weights sums the head groups' parts on every rank, and the partials
leave through ``mesh.reduce_from_group`` (all-reduce forward, identity
backward): a rank's gradients equal the one-process call's.
"""

from __future__ import annotations

import torch

from super_resolution_tpu_torch.ops.cuda_attention import (
    fused_msa_block, fused_msa_block_shifted, fused_ocab_block_ad,
    msa_block_reference, msa_block_shifted_reference)
from super_resolution_tpu_torch.ops.cuda_build import with_plain_backward
from super_resolution_tpu_torch.parallel.mesh import (axis_rank, axis_size,
                                                      copy_to_group,
                                                      reduce_from_group)


def head_group(heads: int, c: int, mesh, axis: str):
    """(group, P, rank, heads a rank, channels a rank) of the head split;
    raises where P does not divide the heads."""
    ntp = axis_size(mesh, axis)
    if heads % ntp:
        raise ValueError(f"{heads} heads do not divide mesh[{axis!r}] "
                         f"({ntp} ranks)")
    hloc = heads // ntp
    return mesh.get_group(axis), ntp, axis_rank(mesh, axis), hloc, \
        hloc * (c // heads)


def column_blocks(w: torch.Tensor, b: torch.Tensor, c: int, col0: int,
                  width: int, blocks: int):
    """The columns [g * c + col0, g * c + col0 + width) of each of the
    ``blocks`` column blocks of an (in, blocks * c) weight and its bias,
    side by side."""
    w_loc = torch.cat([w[:, g * c + col0:g * c + col0 + width]
                       for g in range(blocks)], 1).contiguous()
    b_loc = torch.cat([b[g * c + col0:g * c + col0 + width]
                       for g in range(blocks)]).contiguous()
    return w_loc, b_loc


def head_parallel_msa_block(x_img, w_qkv, b_qkv, w_proj, b_proj, bias,
                            mask=None, *, heads: int, window_size: int,
                            mesh, axis: str = "model",
                            scale: float | None = None, shift: int = 0):
    """``fused_msa_block`` (``shift`` 0) or ``fused_msa_block_shifted``
    with the heads split over mesh[axis]. Arguments as theirs, weights in
    the (in, out) layout; ``heads`` is the whole head count, which P must
    divide. Every rank returns the whole output."""
    c = x_img.shape[-1]
    group, _, r, hloc, c_loc = head_group(heads, c, mesh, axis)
    if scale is None:
        scale = (c // heads) ** -0.5
    col0 = r * c_loc
    x_in, w_qkv, w_proj, bias = (copy_to_group(t, group)
                                 for t in (x_img, w_qkv, w_proj, bias))
    b_qkv = copy_to_group(b_qkv, group)
    w_loc, b_loc = column_blocks(w_qkv, b_qkv, c, col0, c_loc, 3)
    args = (x_in.contiguous(), w_loc, b_loc,
            w_proj[col0:col0 + c_loc].contiguous(),
            torch.zeros_like(b_proj), bias[r * hloc:(r + 1) * hloc]
            .contiguous())
    kw = dict(heads=hloc, window_size=window_size, scale=scale)
    if shift:
        partial = with_plain_backward(
            fused_msa_block_shifted, msa_block_shifted_reference,
            args + (mask,), shift=shift, **kw)
    else:
        partial = with_plain_backward(fused_msa_block, msa_block_reference,
                                      args, mask=mask, **kw)
    # row-parallel reduce; the output bias is added once, after the sum
    return reduce_from_group(partial, group) + b_proj.to(partial.dtype)


def head_parallel_ocab_block(x_img, ln_scale, ln_bias, w_q, b_q, w_kv, b_kv,
                             w_proj, b_proj, bias, *, heads: int,
                             window_size: int, overlap_win: int, mesh,
                             axis: str = "model",
                             scale: float | None = None,
                             ln_eps: float = 1e-5):
    """``fused_ocab_block`` with the heads split over mesh[axis]: a rank
    takes its heads' q columns, the matching k and v column pair of the
    (C, 2C) kv weight, the proj rows and the bias heads, and runs the
    kernel with ``residual_scale = 1 / P`` (the LayerNorm runs whole on
    every rank); the partials all-reduce and the proj bias is added once.
    """
    c = x_img.shape[-1]
    group, ntp, r, hloc, c_loc = head_group(heads, c, mesh, axis)
    if scale is None:
        scale = (c // heads) ** -0.5
    col0 = r * c_loc
    (x_in, ln_scale, ln_bias, w_q, b_q, w_kv, b_kv, w_proj, bias) = (
        copy_to_group(t, group) for t in (x_img, ln_scale, ln_bias, w_q,
                                          b_q, w_kv, b_kv, w_proj, bias))
    wq_loc, bq_loc = column_blocks(w_q, b_q, c, col0, c_loc, 1)
    wkv_loc, bkv_loc = column_blocks(w_kv, b_kv, c, col0, c_loc, 2)
    partial = fused_ocab_block_ad(
        x_in.contiguous(), ln_scale, ln_bias, wq_loc, bq_loc, wkv_loc,
        bkv_loc, w_proj[col0:col0 + c_loc].contiguous(),
        torch.zeros_like(b_proj), bias[r * hloc:(r + 1) * hloc].contiguous(),
        heads=hloc, window_size=window_size, overlap_win=overlap_win,
        scale=scale, ln_eps=ln_eps, residual_scale=1.0 / ntp)
    return reduce_from_group(partial, group) + b_proj.to(partial.dtype)
