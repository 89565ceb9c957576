"""SRFormer, permuted self-attention SR, NHWC (port of
super_resolution_tpu/models/srformer_arch.py).

Inside each window K and V are channel-compressed (dim -> dim / 2) and
their 2 x 2 spatial sub-positions folded into channels, which shrinks the
key set to N / 4 while Q keeps full resolution (PSA). The relative position
bias lives on the permuted half-resolution grid and reaches the
full-resolution queries through the aligned index. The FFN is a ConvFFN
with a 5 x 5 depthwise branch. The macro structure is SwinIR's.

Module and parameter names follow the torch checkpoints
(``layers.0.residual_group.blocks.1.attn.kv.weight``,
``...mlp.dwconv.depthwise_conv.0.weight``,
``...attn.aligned_relative_position_index``, ``...blocks.1.attn_mask``), so
a state_dict with the official names loads with ``strict=True``.

On the card every block goes through ``fused_psa_block``
(``ops/cuda_psa.py``) by its ``fused_psa_block_ad`` entry (the kernel
forward, autograd through the plain version backward), which launches its
CUDA kernel or raises a ``ValueError`` that names the limit; the kv
projection and the permuted fold run on the whole image before it, which
the network pads to a window multiple first. A CPU tensor takes the
windowed plain path through :class:`PSA`.

Training (JAX ``srformer_arch.py:180-233``, ``:295-311``): block i of the
network has the drop-path rate linspace(0, drop_path_rate, blocks)[i]; in
training mode a block whose rate is above 0 drops its attention and FFN
branches (the attention keeps its kernel, the ConvFFN is plain PyTorch in
every mode, as in JAX). The draws, and ``use_checkpoint``'s per-group
remat, are ``arch_util.SRShell.run_layers``'s.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
from torch import nn

from super_resolution_tpu_torch.models.arch_util import (LN_EPS,
                                                         DepthwiseConvFFN,
                                                         DropPathBlock,
                                                         DropPathGroup,
                                                         KernelOperands,
                                                         SRShell, conv_nhwc,
                                                         drop_path,
                                                         gather_bias,
                                                         index_buffer,
                                                         layer_norm,
                                                         run_blocks)
from super_resolution_tpu_torch.ops.attention import attention_with_bias
from super_resolution_tpu_torch.ops.cuda_build import use_kernel
from super_resolution_tpu_torch.ops.cuda_psa import fused_psa_block_ad
from super_resolution_tpu_torch.ops.windowing import (window_partition,
                                                      window_reverse)
from super_resolution_tpu_torch.utils.registry import ARCH_REGISTRY


def aligned_rpi(pws: int) -> np.ndarray:
    """(4 * pws^2, pws^2) aligned relative-position index (a copy of the
    JAX package's numpy function)."""
    coords = np.stack(np.meshgrid(np.arange(pws), np.arange(pws),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += pws - 1
    rel[:, :, 1] += pws - 1
    rel[:, :, 0] *= 2 * pws - 1
    idx = rel.sum(-1)                                     # (pws^2, pws^2)
    idx = idx.reshape(pws, pws, 1, 1, pws * pws)
    idx = np.tile(idx, (1, 1, 2, 2, 1))
    idx = idx.transpose(0, 2, 1, 3, 4).reshape(4 * pws * pws, pws * pws)
    return idx.astype(np.int32)


def psa_shift_mask(h: int, w: int, window_size: int,
                   shift_size: int) -> np.ndarray:
    """(nW, ws^2, pws^2) rectangular shift mask of 0 / -100 (a copy of the
    JAX package's numpy function)."""
    def region_ids(hh, ww, ws, ss):
        m = np.zeros((hh, ww))
        slices = (slice(0, -ws), slice(-ws, -ss), slice(-ss, None))
        cnt = 0
        for hs in slices:
            for wsl in slices:
                m[hs, wsl] = cnt
                cnt += 1
        nh, nw = hh // ws, ww // ws
        mw = m.reshape(nh, ws, nw, ws).transpose(0, 2, 1, 3)
        return mw.reshape(-1, ws * ws)

    full = region_ids(h, w, window_size, shift_size)
    perm = region_ids(h // 2, w // 2, window_size // 2, shift_size // 2)
    diff = full[:, :, None] - perm[:, None, :]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=16)
def psa_shift_mask_tensor(h: int, w: int, window_size: int, shift_size: int,
                          device: str) -> torch.Tensor:
    """``psa_shift_mask`` as a float32 tensor on ``device``, built once per
    shape and shared by every caller, which must not modify it."""
    return torch.from_numpy(
        psa_shift_mask(h, w, window_size, shift_size)).to(device)


def permuted_kv_windows(kv_img, window_size: int):
    """(B, H, W, C / 2) projected kv image -> (B * nW, (ws / 2)^2, 2C)
    compressed windows, channels [K (C) | V (C)]: each 2 x 2 neighbourhood's
    (kv, C / 4) channel slices become one token. The fold on the whole image
    equals the fold per window because ws is even and windows start on even
    rows and columns."""
    b, hh, ww, c2 = kv_img.shape
    c, c4 = 2 * c2, c2 // 2
    kvc = kv_img.reshape(b, hh // 2, 2, ww // 2, 2, 2, c4)
    kvc = kvc.permute(0, 1, 3, 5, 2, 4, 6).reshape(b, hh // 2, ww // 2, 2 * c)
    pws = window_size // 2
    return window_partition(kvc, pws).reshape(-1, pws * pws, 2 * c)


class PSA(nn.Module):
    """Permuted self-attention: the parameters, and the plain computation
    over pre-partitioned windows for shapes the fused route does not
    take."""

    def __init__(self, dim: int, window_size: int, num_heads: int):
        super().__init__()
        pws = window_size // 2
        self.window_size = window_size
        self.num_heads = num_heads
        self.kv = nn.Linear(dim, dim // 2)
        self.q = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * pws - 1) * (2 * pws - 1), num_heads))
        self.register_buffer("aligned_relative_position_index",
                             index_buffer(aligned_rpi(pws)))

    def bias(self) -> torch.Tensor:
        """(heads, N, N / 4) float32 aligned RPB."""
        return gather_bias(self.relative_position_bias_table,
                           self.aligned_relative_position_index,
                           self.num_heads)

    def forward(self, x_windows, mask=None):
        """x_windows: (B * nW, N, C); mask: (nW, N, N / 4) or None."""
        bw, n, c = x_windows.shape
        pws = self.window_size // 2
        h = self.num_heads
        d = c // h
        nk = n // 4
        kv = self.kv(x_windows).reshape(bw, pws, 2, pws, 2, 2, c // 4)
        kv = kv.permute(0, 1, 3, 5, 2, 4, 6)
        k, v = kv.reshape(bw, nk, 2, h, d).permute(2, 0, 3, 1, 4)
        q = self.q(x_windows).reshape(bw, n, h, d).transpose(1, 2)
        bias = self.bias()
        if mask is not None:
            nw = mask.shape[0]
            out = attention_with_bias(
                q.reshape(bw // nw, nw, h, n, d),
                k.reshape(bw // nw, nw, h, nk, d),
                v.reshape(bw // nw, nw, h, nk, d),
                bias[None, None] + mask[None, :, None], scale=d ** -0.5)
            out = out.reshape(bw, h, n, d)
        else:
            out = attention_with_bias(q, k, v, bias, scale=d ** -0.5)
        return self.proj(out.transpose(1, 2).reshape(bw, n, c))


class ConvFFN(DepthwiseConvFFN):
    """fc1 -> GELU -> (+ 5 x 5 depthwise conv, GELU) -> fc2."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__(in_features, hidden, 5)


class PSABlock(KernelOperands, DropPathBlock):
    """norm1 -> (shifted) permuted self-attention -> residual -> norm2 ->
    ConvFFN -> residual; in training mode at a rate above 0 with drop path
    on both branches (:meth:`takes_draws`)."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 24,
                 shift_size: int = 0, mlp_ratio: float = 2.0,
                 input_resolution: Sequence[int] | None = None,
                 drop_path_rate: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.shift_size = shift_size
        self.drop_path_rate = drop_path_rate
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = PSA(dim, window_size, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = ConvFFN(dim, int(dim * mlp_ratio))
        # the checkpoints keep a shifted block's mask at the training size;
        # the forward builds the mask of the size it is given
        if (shift_size > 0 and input_resolution is not None
                and not any(r % window_size for r in input_resolution)):
            self.register_buffer("attn_mask", torch.from_numpy(psa_shift_mask(
                *input_resolution, window_size, shift_size)))

    def _build_operands(self) -> dict:
        at = self.attn
        return {"psa": (at.q.weight.t().contiguous(), at.q.bias,
                        at.proj.weight.t().contiguous(), at.proj.bias),
                "bias": at.bias()}

    def forward(self, x, draws=None):
        """``draws``: (2, B) uniform draws of the attention and FFN
        branches' drop path, given where :meth:`takes_draws`."""
        _, hh, ww, c = x.shape
        ws, ss = self.window_size, self.shift_size
        heads = self.num_heads
        shortcut = x
        x = layer_norm(self.norm1, x)
        mask = None
        if ss > 0:
            x = torch.roll(x, (-ss, -ss), dims=(1, 2))
            mask = psa_shift_mask_tensor(hh, ww, ws, ss, str(x.device))
        if use_kernel(x):
            ops = self.kernel_operands()
            kvw = permuted_kv_windows(self.attn.kv(x), ws)
            x = fused_psa_block_ad(x.contiguous(), *ops["psa"],
                                   kvw.contiguous(), ops["bias"], mask,
                                   heads=heads, window_size=ws,
                                   scale=(c // heads) ** -0.5)
        else:
            x_windows = window_partition(x, ws).reshape(-1, ws * ws, c)
            x = window_reverse(self.attn(x_windows, mask).reshape(
                -1, ws, ws, c), ws, hh, ww)
        if ss > 0:
            x = torch.roll(x, (ss, ss), dims=(1, 2))
        if not self.takes_draws():
            x = shortcut + x
            return x + self.mlp(layer_norm(self.norm2, x))
        rate = self.drop_path_rate
        x = shortcut + drop_path(x, rate, draws[0])
        return x + drop_path(self.mlp(layer_norm(self.norm2, x)), rate,
                             draws[1])


class PSABasicLayer(nn.Module):
    """A group's blocks; block i has drop-path rate ``drop_path_rates[i]``
    (0 where the list is empty)."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size: int, mlp_ratio: float = 2.0,
                 input_resolution: Sequence[int] | None = None,
                 drop_path_rates: Sequence[float] = ()):
        super().__init__()
        rates = list(drop_path_rates) or [0.0] * depth
        self.blocks = nn.ModuleList([
            PSABlock(dim, num_heads, window_size,
                     0 if i % 2 == 0 else window_size // 2, mlp_ratio,
                     input_resolution, rates[i])
            for i in range(depth)])

    def forward(self, x, draws=None):
        return run_blocks(self.blocks, x, draws)


class PSAGroup(DropPathGroup):
    """residual_group + conv + skip."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size: int, mlp_ratio: float = 2.0,
                 resi_connection: str = "1conv",
                 input_resolution: Sequence[int] | None = None,
                 drop_path_rates: Sequence[float] = ()):
        super().__init__()
        if resi_connection != "1conv":
            raise NotImplementedError(resi_connection)
        self.residual_group = PSABasicLayer(dim, depth, num_heads,
                                            window_size, mlp_ratio,
                                            input_resolution, drop_path_rates)
        self.conv = nn.Conv2d(dim, dim, 3, 1, 1)

    def forward(self, x, draws=None):
        return conv_nhwc(self.conv, self.residual_group(x, draws)) + x


@ARCH_REGISTRY.register()
class SRFormer(SRShell):
    """SRFormer: shallow conv -> PSA groups -> norm, body conv and global
    residual -> reconstruction (``arch_util.SRShell``, all three upsampler
    branches). Input and output are NHWC; an input that is no window
    multiple is reflect-padded at the bottom and the right.

    ``drop_path_rate`` and ``use_checkpoint`` act in training mode only (the
    module docstring); ``forward(x, generator=g)`` draws the drop path from
    ``g``.

    Weights start at torch's defaults; ``models.arch_util.init_weights``
    gives the seeded initialisation, a checkpoint gives trained ones.
    """

    def __init__(self, img_size: int = 48, in_chans: int = 3,
                 embed_dim: int = 96, depths: Sequence[int] = (6, 6, 6, 6),
                 num_heads: Sequence[int] = (6, 6, 6, 6),
                 window_size: int = 24, mlp_ratio: float = 2.0,
                 drop_path_rate: float = 0.1, patch_norm: bool = True,
                 upscale: int = 2, img_range: float = 1.0,
                 upsampler: str = "", resi_connection: str = "1conv",
                 use_checkpoint: bool = False):
        if upsampler not in ("pixelshuffle", "pixelshuffledirect", ""):
            raise NotImplementedError(upsampler)
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        starts = np.cumsum([0, *depths]).tolist()
        layers = [
            PSAGroup(embed_dim, depth, num_heads[i], window_size, mlp_ratio,
                     resi_connection, (img_size, img_size),
                     dpr[starts[i]:starts[i] + depth])
            for i, depth in enumerate(depths)]
        super().__init__(layers, in_chans, embed_dim, window_size, patch_norm,
                         upscale, img_range, upsampler, resi_connection,
                         pad_mode="reflect")
        self.use_checkpoint = use_checkpoint
