"""Hidden-parallel fused MLP tails: tensor parallelism composed with the
MLP tail kernels (port of super_resolution_tpu/parallel/tp_ffn.py).

Each rank of the ``model`` axis slices its hidden block out of the
replicated fc1 (columns, and the bias) and fc2 (rows), runs the unchanged
kernel (``mlp_block``, ``mlp_block_sum3(_shifted)``) on its slice with
``residual_scale = 1 / P`` and the fc2 bias left out, and all-reduces the
partials over ``model``: the residual and the MLP partials add up exactly,
and the fc2 bias is added once. The LayerNorm runs whole on every rank (it
normalises over all channels); in the sum3 forms it sees the whole 3-way
sum, and only that sum's residual share is scaled by 1 / P. Autograd as in
``tp_attention.py``.
"""

from __future__ import annotations

import torch

from super_resolution_tpu_torch.ops.cuda_ffn import (mlp_block_ad,
                                                     mlp_block_sum3_ad,
                                                     mlp_block_sum3_shifted_ad)
from super_resolution_tpu_torch.parallel.mesh import (axis_rank, axis_size,
                                                      copy_to_group,
                                                      reduce_from_group)


def _hidden_slice(gamma, beta, w1, b1, w2, mesh, axis: str):
    """(group, P, the replicated operands entered into the group and
    sliced to this rank's hidden block); raises where P does not divide the
    hidden dim."""
    hid = w1.shape[1]
    ntp = axis_size(mesh, axis)
    if hid % ntp:
        raise ValueError(f"hidden dim {hid} does not divide mesh[{axis!r}] "
                         f"({ntp} ranks)")
    group = mesh.get_group(axis)
    hloc = hid // ntp
    h0 = axis_rank(mesh, axis) * hloc
    gamma, beta, w1, b1, w2 = (copy_to_group(t, group)
                               for t in (gamma, beta, w1, b1, w2))
    return group, ntp, (gamma, beta, w1[:, h0:h0 + hloc].contiguous(),
                        b1[h0:h0 + hloc].contiguous(),
                        w2[h0:h0 + hloc].contiguous())


def hidden_parallel_mlp_block(x, gamma, beta, w1, b1, w2, b2, *, mesh,
                              axis: str = "model", eps: float = 1e-5):
    """``mlp_block`` (x + MLP(LN(x))) with the hidden dim split over
    mesh[axis]; arguments as its, weights in the (in, out) layout."""
    group, ntp, ops = _hidden_slice(gamma, beta, w1, b1, w2, mesh, axis)
    partial = mlp_block_ad(copy_to_group(x, group).contiguous(), *ops,
                           torch.zeros_like(b2), eps=eps,
                           residual_scale=1.0 / ntp)
    return reduce_from_group(partial, group) + b2.to(partial.dtype)


def hidden_parallel_mlp_sum3(shortcut, attn_x, conv_x, gamma, beta, w1, b1,
                             w2, b2, *, conv_scale: float, mesh,
                             axis: str = "model", eps: float = 1e-5,
                             shift: int = 0):
    """``mlp_block_sum3`` (``shift`` 0) or ``mlp_block_sum3_shifted`` (the
    attention input still rolled by ``shift``) with the hidden dim split
    over mesh[axis]."""
    group, ntp, ops = _hidden_slice(gamma, beta, w1, b1, w2, mesh, axis)
    ins = tuple(copy_to_group(t, group).contiguous()
                for t in (shortcut, attn_x, conv_x))
    kw = dict(conv_scale=conv_scale, eps=eps, residual_scale=1.0 / ntp)
    if shift:
        partial = mlp_block_sum3_shifted_ad(*ins, *ops, torch.zeros_like(b2),
                                            shift=shift, **kw)
    else:
        partial = mlp_block_sum3_ad(*ins, *ops, torch.zeros_like(b2), **kw)
    return reduce_from_group(partial, group) + b2.to(partial.dtype)
