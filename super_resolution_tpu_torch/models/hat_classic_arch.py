"""Classic HAT, the structure official HAT checkpoints describe (port of
super_resolution_tpu/models/hat_classic_arch.py).

Module and parameter names follow the official torch checkpoints
(``layers.0.residual_group.blocks.1.attn.qkv.weight``, ...), so a
state_dict with official names loads with ``strict=True``. Activations are
NHWC throughout.

Every HAB and OCAB goes through the seven kernel wrappers of
``ops/cuda_attention.py``, ``ops/cuda_ffn.py`` and
``ops/cuda_hab_block.py``, each through its ``*_ad`` entry (the kernel
forward; autograd through the plain version backward); each wrapper runs
its plain PyTorch version for a CPU tensor and launches its CUDA kernel for
a CUDA tensor. Per RHAG: each unshifted HAB calls ``fused_msa_block`` then
``mlp_block_sum3``, each shifted HAB ``fused_msa_block_shifted`` then
``mlp_block_sum3_shifted``, and the OCAB ``fused_ocab_block`` then
``mlp_block``. With ``hab_route="fused_hab_block"`` each unshifted HAB
calls ``fused_hab_block`` once instead of its two: the whole block in one
kernel, the attention image never written.

Training (JAX ``hat_classic_arch.py:202-373``, ``:586-620``): block i of
the network has the drop-path rate linspace(0, drop_path_rate, blocks)[i].
In training mode a HAB whose rate is above 0 keeps its attention kernel,
drops its attention branch, and runs its MLP tail unfused with drop path
(JAX's route); every other HAB, and every HAB in eval mode, runs the
kernels above. The draws, and ``use_checkpoint``'s per-RHAG remat, are
``arch_util.SRShell.run_layers``'s.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from super_resolution_tpu_torch.models.arch_util import (LN_EPS,
                                                         DropPathBlock,
                                                         DropPathGroup,
                                                         HATShell,
                                                         KernelOperands,
                                                         conv_nhwc,
                                                         drop_path,
                                                         gather_bias,
                                                         gelu_exact,
                                                         index_buffer,
                                                         layer_norm,
                                                         mlp_operands,
                                                         run_blocks)
from super_resolution_tpu_torch.ops.attention import (
    relative_position_index_oca, relative_position_index_sa,
    shift_attn_mask_tensor)
from super_resolution_tpu_torch.ops.cuda_attention import (
    fused_msa_block_ad, fused_msa_block_shifted_ad, fused_ocab_block_ad)
from super_resolution_tpu_torch.ops.cuda_ffn import (
    mlp_block_ad, mlp_block_sum3_ad, mlp_block_sum3_shifted_ad)
from super_resolution_tpu_torch.ops.cuda_hab_block import fused_hab_block_ad
from super_resolution_tpu_torch.parallel.tp import tp_route_for
from super_resolution_tpu_torch.parallel.tp_attention import (
    head_parallel_msa_block, head_parallel_ocab_block)
from super_resolution_tpu_torch.parallel.tp_ffn import (
    hidden_parallel_mlp_block, hidden_parallel_mlp_sum3)
from super_resolution_tpu_torch.utils.registry import ARCH_REGISTRY

HAB_ROUTES = ("split", "fused_hab_block")


class ChannelAttention(nn.Module):
    """Squeeze channel attention: GAP -> 1x1 down -> ReLU -> 1x1 up ->
    sigmoid, under the official Sequential names ('attention.{1,3}')."""

    def __init__(self, num_feat: int, squeeze_factor: int = 16):
        super().__init__()
        mid = num_feat // squeeze_factor
        self.attention = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Conv2d(num_feat, mid, 1),
            nn.ReLU(inplace=True), nn.Conv2d(mid, num_feat, 1), nn.Sigmoid())

    def forward(self, x):
        down, up = self.attention[1], self.attention[3]
        y = x.mean(dim=(1, 2), keepdim=True)
        y = F.relu(F.linear(y, down.weight.flatten(1), down.bias))
        y = torch.sigmoid(F.linear(y, up.weight.flatten(1), up.bias))
        return x * y


class CABClassic(nn.Module):
    """Classic CAB: 3x3 compress -> GELU -> 3x3 expand -> ChannelAttention."""

    def __init__(self, num_feat: int, compress_ratio: int = 3,
                 squeeze_factor: int = 30):
        super().__init__()
        mid = num_feat // compress_ratio
        self.cab = nn.Sequential(
            nn.Conv2d(num_feat, mid, 3, 1, 1), nn.GELU(),
            nn.Conv2d(mid, num_feat, 3, 1, 1),
            ChannelAttention(num_feat, squeeze_factor))

    def forward(self, x):
        y = conv_nhwc(self.cab[2], gelu_exact(conv_nhwc(self.cab[0], x)))
        return self.cab[3](y)


class WindowAttentionClassic(nn.Module):
    """The parameters of (S)W-MSA with relative position bias; the
    computation is the fused kernel's (``fused_msa_block``)."""

    def __init__(self, dim: int, window_size: int, num_heads: int):
        super().__init__()
        ws = window_size
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * ws - 1) * (2 * ws - 1), num_heads))
        self.register_buffer(
            "rpi", index_buffer(relative_position_index_sa(ws)),
            persistent=False)

    def bias(self) -> torch.Tensor:
        """(heads, N, N) float32 RPB."""
        return gather_bias(self.relative_position_bias_table, self.rpi,
                            self.num_heads)


class Mlp(nn.Module):
    """fc1 -> GELU -> fc2 (official names), run by the fused tail kernels;
    ``forward`` is the unfused route of a block with drop path."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden)
        self.act = nn.GELU()
        self.fc2 = nn.Linear(hidden, in_features)

    def forward(self, x):
        return self.fc2(gelu_exact(self.fc1(x)))


class HABClassic(KernelOperands, DropPathBlock):
    """Classic hybrid attention block: (S)W-MSA + conv_scale * CAB, then
    the MLP tail with the 3-way residual. ``hab_route``: ``split`` runs the
    attention and the tail as two kernels, ``fused_hab_block`` an unshifted
    block as one (a shifted block keeps the two: its roll-back lies between
    them). In training mode with ``drop_path_rate`` above 0 the tail runs
    unfused, with drop path on both branches (:meth:`takes_draws`)."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 shift_size: int = 0, compress_ratio: int = 3,
                 squeeze_factor: int = 30, conv_scale: float = 0.01,
                 mlp_ratio: float = 4.0, hab_route: str = "split",
                 drop_path_rate: float = 0.0):
        super().__init__()
        if hab_route not in HAB_ROUTES:
            raise ValueError(f"hab_route {hab_route!r}: one of {HAB_ROUTES}")
        self.hab_route = hab_route
        self.num_heads = num_heads
        self.window_size = window_size
        self.shift_size = shift_size
        self.conv_scale = conv_scale
        self.drop_path_rate = drop_path_rate
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttentionClassic(dim, window_size, num_heads)
        self.conv_block = CABClassic(dim, compress_ratio, squeeze_factor)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def _build_operands(self) -> dict:
        at = self.attn
        return {
            "msa": (at.qkv.weight.t().contiguous(), at.qkv.bias,
                    at.proj.weight.t().contiguous(), at.proj.bias,
                    at.bias()),
            "tail": mlp_operands(self.norm2, self.mlp.fc1, self.mlp.fc2),
        }

    def forward(self, x, draws=None):
        """``draws``: (2, B) uniform draws of the attention and MLP
        branches' drop path, given where :meth:`takes_draws`. Under
        tensor parallelism (``parallel.tp.tp_attention``) the attention
        runs head-parallel where the model axis divides the heads, and the
        tail hidden-parallel where it divides the hidden dim (the split
        route, whatever ``hab_route`` says); a part that neither route
        covers launches its kernels on the whole weights."""
        _, hh, ww, c = x.shape
        ws, ss = self.window_size, self.shift_size
        ops = self.kernel_operands()
        msa = dict(heads=self.num_heads, window_size=ws,
                   scale=(c // self.num_heads) ** -0.5)
        x = x.contiguous()
        xn = layer_norm(self.norm1, x)
        conv_x = self.conv_block(xn).contiguous()
        unfused = self.takes_draws()
        tp_heads = tp_route_for(self.num_heads)
        tp_hidden = tp_route_for(self.mlp.fc1.out_features)
        mask = (shift_attn_mask_tensor(hh, ww, ws, ss, str(x.device))
                if ss > 0 else None)
        if tp_heads is not None:
            attn = head_parallel_msa_block(
                xn, *ops["msa"], mask, **msa, shift=ss, mesh=tp_heads[0],
                axis=tp_heads[1])
        elif ss > 0:
            attn = fused_msa_block_shifted_ad(xn, *ops["msa"], mask,
                                              shift=ss, **msa)
        elif (self.hab_route == "fused_hab_block" and not unfused
              and tp_hidden is None):
            return fused_hab_block_ad(xn, x, conv_x, *ops["msa"],
                                      *ops["tail"], **msa,
                                      conv_scale=self.conv_scale,
                                      eps=self.norm2.eps)
        else:
            attn = fused_msa_block_ad(xn, *ops["msa"], **msa)
        if not unfused:
            tail = dict(conv_scale=self.conv_scale)
            if tp_hidden is not None:
                return hidden_parallel_mlp_sum3(
                    x, attn, conv_x, *ops["tail"], **tail, shift=ss,
                    mesh=tp_hidden[0], axis=tp_hidden[1], eps=self.norm2.eps)
            if ss > 0:
                return mlp_block_sum3_shifted_ad(x, attn, conv_x,
                                                 *ops["tail"], **tail,
                                                 shift=ss)
            return mlp_block_sum3_ad(x, attn, conv_x, *ops["tail"], **tail)
        if ss > 0:
            attn = torch.roll(attn, (ss, ss), dims=(1, 2))
        rate = self.drop_path_rate
        x = x + drop_path(attn, rate, draws[0]) + conv_x * self.conv_scale
        return x + drop_path(self.mlp(layer_norm(self.norm2, x)), rate,
                             draws[1])


class OCABClassic(KernelOperands):
    """Classic OCAB: fused qkv projection; Q from ws-windows, K and V from
    overlapping ow-windows; then the MLP tail."""

    def __init__(self, dim: int, window_size: int, overlap_ratio: float,
                 num_heads: int, mlp_ratio: float = 2.0):
        super().__init__()
        ws = window_size
        self.num_heads = num_heads
        self.window_size = ws
        self.overlap_win_size = int(ws * overlap_ratio) + ws
        ow = self.overlap_win_size
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.qkv = nn.Linear(dim, dim * 3)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((ws + ow - 1) * (ws + ow - 1), num_heads))
        self.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.register_buffer(
            "rpi", index_buffer(relative_position_index_oca(ws,
                                                             overlap_ratio)),
            persistent=False)

    def _build_operands(self) -> dict:
        w, b = self.qkv.weight, self.qkv.bias
        c = w.shape[1]
        return {
            "attn": (self.norm1.weight, self.norm1.bias,
                     w[:c].t().contiguous(), b[:c],
                     w[c:].t().contiguous(), b[c:],
                     self.proj.weight.t().contiguous(), self.proj.bias,
                     gather_bias(self.relative_position_bias_table,
                                  self.rpi, self.num_heads)),
            "tail": mlp_operands(self.norm2, self.mlp.fc1, self.mlp.fc2),
        }

    def forward(self, x):
        """Under tensor parallelism the attention half runs head-parallel
        and the tail hidden-parallel where the model axis divides them."""
        c = x.shape[-1]
        ops = self.kernel_operands()
        kw = dict(heads=self.num_heads, window_size=self.window_size,
                  overlap_win=self.overlap_win_size,
                  scale=(c // self.num_heads) ** -0.5, ln_eps=self.norm1.eps)
        tp_heads = tp_route_for(self.num_heads)
        if tp_heads is not None:
            x = head_parallel_ocab_block(x.contiguous(), *ops["attn"], **kw,
                                         mesh=tp_heads[0], axis=tp_heads[1])
        else:
            x = fused_ocab_block_ad(x.contiguous(), *ops["attn"], **kw)
        tp_hidden = tp_route_for(self.mlp.fc1.out_features)
        if tp_hidden is not None:
            return hidden_parallel_mlp_block(
                x.contiguous(), *ops["tail"], mesh=tp_hidden[0],
                axis=tp_hidden[1], eps=self.norm2.eps)
        return mlp_block_ad(x.contiguous(), *ops["tail"], eps=self.norm2.eps)


class AttenBlocksClassic(nn.Module):
    """depth x HABClassic followed by one OCABClassic; block i has
    drop-path rate ``drop_path_rates[i]`` (0 where the list is empty)."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size: int, compress_ratio: int, squeeze_factor: int,
                 conv_scale: float, overlap_ratio: float,
                 mlp_ratio: float = 4.0, hab_route: str = "split",
                 drop_path_rates: Sequence[float] = ()):
        super().__init__()
        rates = list(drop_path_rates) or [0.0] * depth
        self.blocks = nn.ModuleList([
            HABClassic(dim, num_heads, window_size,
                       0 if i % 2 == 0 else window_size // 2,
                       compress_ratio, squeeze_factor, conv_scale, mlp_ratio,
                       hab_route, rates[i])
            for i in range(depth)])
        self.overlap_attn = OCABClassic(dim, window_size, overlap_ratio,
                                        num_heads, mlp_ratio)

    def forward(self, x, draws=None):
        """``draws``: one (2, B) for each block that takes draws, in
        order."""
        return self.overlap_attn(run_blocks(self.blocks, x, draws))


class RHAGClassic(DropPathGroup):
    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size: int, compress_ratio: int, squeeze_factor: int,
                 conv_scale: float, overlap_ratio: float,
                 mlp_ratio: float = 4.0, resi_connection: str = "1conv",
                 hab_route: str = "split",
                 drop_path_rates: Sequence[float] = ()):
        super().__init__()
        self.residual_group = AttenBlocksClassic(
            dim, depth, num_heads, window_size, compress_ratio,
            squeeze_factor, conv_scale, overlap_ratio, mlp_ratio, hab_route,
            drop_path_rates)
        if resi_connection == "1conv":
            self.conv = nn.Conv2d(dim, dim, 3, 1, 1)
        elif resi_connection == "identity":
            self.conv = None
        else:
            raise ValueError(f"Unknown resi_connection: {resi_connection}")

    def forward(self, x, draws=None):
        y = self.residual_group(x, draws)
        if self.conv is not None:
            y = conv_nhwc(self.conv, y)
        return y + x


@ARCH_REGISTRY.register()
class HATClassic(HATShell):
    """Classic HAT: shallow conv -> RHAGs -> norm, body conv and global
    residual -> pixel-shuffle reconstruction (``arch_util.HATShell``). Input
    and output are NHWC. ``hab_route`` picks the kernels of the unshifted
    HABs (:class:`HABClassic`); the default is the split route.
    ``drop_path_rate`` and ``use_checkpoint`` act in training mode only (the
    module docstring); ``forward(x, generator=g)`` draws the drop path from
    ``g`` (torch's default generator where None).

    Weights start at torch's defaults; ``models.arch_util.init_weights``
    gives the seeded initialisation, a checkpoint gives trained ones.
    """

    def __init__(self, img_size: int = 64, in_chans: int = 3,
                 embed_dim: int = 96, depths: Sequence[int] = (6, 6, 6, 6),
                 num_heads: Sequence[int] = (6, 6, 6, 6),
                 window_size: int = 7, compress_ratio: int = 3,
                 squeeze_factor: int = 30, conv_scale: float = 0.01,
                 overlap_ratio: float = 0.5, mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.1, patch_norm: bool = True,
                 upscale: int = 2, img_range: float = 1.0,
                 upsampler: str = "pixelshuffle",
                 resi_connection: str = "1conv",
                 use_checkpoint: bool = False, stream_tail_rows: int = 0,
                 hab_route: str = "split"):
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        starts = np.cumsum([0, *depths]).tolist()
        layers = [
            RHAGClassic(embed_dim, depth, num_heads[i], window_size,
                        compress_ratio, squeeze_factor, conv_scale,
                        overlap_ratio, mlp_ratio, resi_connection, hab_route,
                        dpr[starts[i]:starts[i] + depth])
            for i, depth in enumerate(depths)]
        super().__init__(layers, in_chans, embed_dim, window_size,
                         overlap_ratio, patch_norm, upscale, img_range,
                         upsampler, resi_connection, stream_tail_rows)
        self.use_checkpoint = use_checkpoint
