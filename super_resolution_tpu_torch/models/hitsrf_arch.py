"""HiT-SRF, hierarchical transformer SR, NHWC (port of
super_resolution_tpu/models/hitsrf_arch.py).

Each block of a group works at another window size (the base window times
its ``hier_win_ratios`` entry) and its SCC attention computes two
correlations per window:
- spatial: the window's queries against values collapsed onto the base
  grid (``spatial_linear`` sums each base cell's sub-grid), plus a
  DynamicPosBias MLP bias averaged over a cell's sub-positions, with no
  softmax;
- channel: a one-head C/2 x C/2 correlation.
A linear projection fuses the halves. Q and V come from a DFE (conv-gated
linear) projection. Blocks are post-norm (the norm follows attention and
MLP) and pad their own input to a multiple of their window.

Module and parameter names follow the torch checkpoints
(``layers.0.residual_group.blocks.1.correlation.qv.conv.2.weight``,
``...correlation.pos.pos1.0.weight``,
``...mlp.dwconv.depthwise_conv.0.weight``), so a state_dict with the
official names loads with ``strict=True``.

Every block goes through ``fused_scc_block`` (``ops/cuda_scc.py``: the
plain version for a CPU tensor; for a CUDA tensor the kernel, or a
``ValueError`` for a shape it cannot take, which
``ops.cuda_scc.scc_block_supported`` tells beforehand), through its
autograd entry ``fused_scc_block_ad`` (the kernel forward, autograd through
the plain version backward: the arb HiT-SRF encoder trains). Both read the
same cached bias.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from super_resolution_tpu_torch.models.arch_util import (LN_EPS,
                                                         DepthwiseConvFFN,
                                                         KernelOperands,
                                                         SRShell, conv_nhwc,
                                                         index_buffer,
                                                         layer_norm)
from super_resolution_tpu_torch.ops.cuda_scc import fused_scc_block_ad
from super_resolution_tpu_torch.ops.windowing import reflect_pad
from super_resolution_tpu_torch.utils.registry import ARCH_REGISTRY


def pointwise(conv: nn.Conv2d, x):
    """A 1 x 1 ``conv`` on an NHWC tensor, as a matrix product."""
    return F.linear(x, conv.weight.flatten(1), conv.bias)


def spatial_bias_index(wh: int, ww: int, bh: int, bw: int) -> np.ndarray:
    """(L, baseL) index of query token (i, j) and base cell (mi, mj) into
    the flattened (2 wh - sh, 2 ww - sw) table of relative-position biases
    averaged over a cell's sh x sw sub-positions: row i - mi sh + wh - sh,
    column j - mj sw + ww - sw."""
    sh, sw = wh // bh, ww // bw
    i, j = np.divmod(np.arange(wh * ww), ww)
    mi, mj = np.divmod(np.arange(bh * bw), bw)
    row = i[:, None] - mi[None, :] * sh + wh - sh
    col = j[:, None] - mj[None, :] * sw + ww - sw
    return (row * (2 * ww - sw) + col).astype(np.int64)


class DFE(nn.Module):
    """Dual feature extraction: a conv branch gated by a linear branch."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        mid = in_features // 5
        self.conv = nn.Sequential(
            nn.Conv2d(in_features, mid, 1, 1, 0), nn.LeakyReLU(0.2, True),
            nn.Conv2d(mid, mid, 3, 1, 1), nn.LeakyReLU(0.2, True),
            nn.Conv2d(mid, out_features, 1, 1, 0))
        self.linear = nn.Conv2d(in_features, out_features, 1, 1, 0)

    def forward(self, x):
        y = F.leaky_relu(pointwise(self.conv[0], x), 0.2)
        y = F.leaky_relu(conv_nhwc(self.conv[2], y), 0.2)
        return pointwise(self.conv[4], y) * pointwise(self.linear, x)


class DynamicPosBias(nn.Module):
    """MLP position bias: (n, 2) relative offsets -> (n, heads)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        pd = dim // 4
        self.pos_proj = nn.Linear(2, pd)
        self.pos1 = nn.Sequential(nn.LayerNorm(pd, eps=LN_EPS),
                                  nn.ReLU(inplace=True), nn.Linear(pd, pd))
        self.pos2 = nn.Sequential(nn.LayerNorm(pd, eps=LN_EPS),
                                  nn.ReLU(inplace=True), nn.Linear(pd, pd))
        self.pos3 = nn.Sequential(nn.LayerNorm(pd, eps=LN_EPS),
                                  nn.ReLU(inplace=True),
                                  nn.Linear(pd, num_heads))

    def forward(self, biases):
        pos = self.pos_proj(biases)
        for seq in (self.pos1, self.pos2, self.pos3):
            pos = seq[2](F.relu(layer_norm(seq[0], pos)))
        return pos


class SCC(KernelOperands):
    """Spatial-channel correlation: the DFE projection to ``[q | v]``,
    then ``fused_scc_block`` on an input that is a multiple of the
    window."""

    def __init__(self, dim: int, base_win_size: Sequence[int],
                 window_size: Sequence[int], num_heads: int):
        super().__init__()
        wh, ww = window_size
        self.window_size = (wh, ww)
        self.base = (min(wh, base_win_size[0]), min(ww, base_win_size[1]))
        self.num_heads = num_heads
        self.qv = DFE(dim, dim)
        self.proj = nn.Linear(dim, dim)
        ratio = (wh * ww) // (self.base[0] * self.base[1])
        self.spatial_linear = nn.Linear(ratio, 1)
        self.pos = DynamicPosBias(dim // 4, num_heads)
        ph, pw = np.arange(1 - wh, wh), np.arange(1 - ww, ww)
        offsets = np.stack(np.meshgrid(ph, pw, indexing="ij"))
        self.register_buffer("rpe", torch.from_numpy(
            offsets.reshape(2, -1).T.astype(np.float32)), persistent=False)
        self.register_buffer("bias_index", index_buffer(
            spatial_bias_index(wh, ww, *self.base)), persistent=False)

    def _spatial_bias(self) -> torch.Tensor:
        """(heads, L, baseL): the MLP's bias of every relative offset,
        averaged over the sub-positions of each base cell. The mean over a
        cell is a box filter of the (2 wh - 1, 2 ww - 1) offset table, so
        the (L, L) gather of all token pairs is never formed."""
        wh, ww = self.window_size
        sh, sw = wh // self.base[0], ww // self.base[1]
        pos = self.pos(self.rpe.to(self.proj.weight.dtype))
        table = pos.float().t().reshape(1, -1, 2 * wh - 1, 2 * ww - 1)
        table = F.avg_pool2d(table, (sh, sw), stride=1).flatten(2)[0]
        return table[:, self.bias_index].to(pos.dtype)

    def _build_operands(self) -> dict:
        sl = self.spatial_linear
        return {"scc": (sl.weight[0].contiguous(), sl.bias[0],
                        self.proj.weight.t().contiguous(), self.proj.bias),
                "bias": self._spatial_bias().float().contiguous()}

    def forward(self, x):
        ops = self.kernel_operands()
        return fused_scc_block_ad(self.qv(x).contiguous(), *ops["scc"],
                                  ops["bias"], heads=self.num_heads,
                                  window_size=self.window_size,
                                  base=self.base)


class ConvFFNHiT(DepthwiseConvFFN):
    """fc1 -> GELU -> (+ 5 x 5 depthwise conv, GELU) -> fc2."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__(in_features, hidden, 5)


class HierarchicalTransformerBlock(nn.Module):
    """Post-norm hierarchical block: SCC at its own window size, then the
    ConvFFN, each followed by its norm and added to its input."""

    def __init__(self, dim: int, num_heads: int,
                 base_win_size: Sequence[int], window_size: Sequence[int],
                 mlp_ratio: float = 2.0):
        super().__init__()
        self.window_size = tuple(window_size)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.correlation = SCC(dim, tuple(base_win_size), self.window_size,
                               num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = ConvFFNHiT(dim, int(dim * mlp_ratio))

    def _pad(self, x):
        """Reflect-pad the bottom and the right to a window multiple."""
        wh, ww = self.window_size
        h, w = x.shape[1], x.shape[2]
        return reflect_pad(x, (wh - h % wh) % wh, (ww - w % ww) % ww)

    def forward(self, x):
        h, w = x.shape[1], x.shape[2]
        y = self.correlation(self._pad(x))[:, :h, :w, :]
        x = x + layer_norm(self.norm1, y)
        return x + layer_norm(self.norm2, self.mlp(x))


class HierarchicalBlocks(nn.Module):
    """The blocks of a group under the checkpoints' name
    (``residual_group.blocks``)."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 base_win_size: Sequence[int], mlp_ratio: float,
                 hier_win_ratios: Sequence[float]):
        super().__init__()
        bws = tuple(base_win_size)
        self.blocks = nn.ModuleList([
            HierarchicalTransformerBlock(
                dim, num_heads, bws,
                (int(bws[0] * hier_win_ratios[i]),
                 int(bws[1] * hier_win_ratios[i])), mlp_ratio)
            for i in range(depth)])

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return x


class RHTB(nn.Module):
    """Residual hierarchical group: blocks + conv + skip."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 base_win_size: Sequence[int], mlp_ratio: float = 2.0,
                 hier_win_ratios: Sequence[float] = (0.5, 1, 2, 4, 6, 8)):
        super().__init__()
        self.residual_group = HierarchicalBlocks(
            dim, depth, num_heads, base_win_size, mlp_ratio, hier_win_ratios)
        self.conv = nn.Conv2d(dim, dim, 3, 1, 1)

    def forward(self, x):
        return conv_nhwc(self.conv, self.residual_group(x)) + x


@ARCH_REGISTRY.register()
class HiT_SRF(SRShell):
    """HiT-SRF: shallow conv -> RHTBs -> norm, body conv and global
    residual -> reconstruction (``arch_util.SRShell``, the ``pixelshuffle``
    and ``pixelshuffledirect`` branches). Input and output are NHWC; each
    block pads its own input, so any size goes in.

    ``expansion_factor`` is what the shipped option files call the FFN
    ratio: given, it takes ``mlp_ratio``'s place. ``resi_connection`` is
    accepted and the body conv is always the one 3 x 3 conv;
    ``use_checkpoint`` is accepted and does nothing at inference.

    Weights start at torch's defaults; ``models.arch_util.init_weights``
    gives the seeded initialisation, a checkpoint gives trained ones.
    """

    def __init__(self, img_size: int = 64, in_chans: int = 3,
                 embed_dim: int = 60, depths: Sequence[int] = (6, 6, 6, 6),
                 num_heads: Sequence[int] = (6, 6, 6, 6),
                 base_win_size: Sequence[int] = (8, 8),
                 mlp_ratio: float = 2.0,
                 expansion_factor: float | None = None,
                 patch_norm: bool = True, upscale: int = 4,
                 img_range: float = 1.0,
                 upsampler: str = "pixelshuffledirect",
                 resi_connection: str = "1conv",
                 hier_win_ratios: Sequence[float] = (0.5, 1, 2, 4, 6, 8),
                 use_checkpoint: bool = False):
        if upsampler not in ("pixelshuffle", "pixelshuffledirect"):
            raise NotImplementedError(upsampler)
        ratio = (mlp_ratio if expansion_factor is None
                 else float(expansion_factor))
        layers = [
            RHTB(embed_dim, depth, num_heads[i], tuple(base_win_size), ratio,
                 tuple(hier_win_ratios))
            for i, depth in enumerate(depths)]
        super().__init__(layers, in_chans, embed_dim, base_win_size[0],
                         patch_norm, upscale, img_range, upsampler, "1conv")
