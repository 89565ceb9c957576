"""HATX, NHWC (port of super_resolution_tpu/models/hatx_arch.py): the fork's
HAT with a spatial-gate FFN in every HAB, and an OCAB that adds a focus bias
to its logits and prunes its keys to the top ``kv_topk_ratio``.

- ``HABX``: norm1 -> {ESC conv attention + conv_scale * CAB} residual, then
  ``SpatialGateDConvFFN`` (fc1 -> depthwise 3 x 3 on the first half ->
  concat(first * GELU(second), second) -> fc2) at ``hab_ffn_ratio``.
- ``OCABX``: q from ws-windows, k and v from overlapping ow-windows with
  ceil padding (``extract_overlap_windows_ceil``), with ``esc_enable`` k and
  v projected from an ESC conv attention of the normed input; with
  ``use_focus_bias`` the tanh of a 1 x 1 conv head's per-key score is added
  to the logits; with ``kv_topk_ratio`` < 1 the keys below the k-th largest
  score (the focus score, else ||k||) get -1e4 before the RPB is added.

The JAX module routes none of this to a Pallas kernel, so neither does the
port: every block is plain PyTorch on the fork HAT's ported parts (``CAB``,
``ESCConvAttn``, ``ConvAttnWrapper``). Module and parameter names follow
the reference's torch checkpoints (``layers.0.residual_group.blocks.1.mlp.dw
.weight``, ``overlap_attn.focus_head.2.weight``, ``overlap_attn.mlp.0
.weight``), the names the flax bridge gives JAX's parameters.

Training: block i of the network has the drop-path rate linspace(0,
drop_path_rate, blocks)[i], on both branches of a HABX in training mode; the
draws of a forward are made at once by ``arch_util.SRShell.run_layers``
from the generator the caller passes to ``forward``, and ``use_checkpoint``
runs each RHAG under ``torch.utils.checkpoint``, as in the fork's HAT.
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
                                                         conv_nhwc,
                                                         drop_path,
                                                         gather_bias,
                                                         gelu_exact,
                                                         index_buffer,
                                                         layer_norm,
                                                         run_blocks)
from super_resolution_tpu_torch.models.esc_arch import (ConvAttnWrapper,
                                                        orthogonal_oihw)
from super_resolution_tpu_torch.models.hat_arch import CAB, ESCConvAttn
from super_resolution_tpu_torch.ops.attention import \
    relative_position_index_oca
from super_resolution_tpu_torch.ops.windowing import (window_partition,
                                                      window_reverse)
from super_resolution_tpu_torch.utils.registry import ARCH_REGISTRY

# the logit of a pruned key (JAX hatx_arch.py's -1e4, before the RPB)
PRUNED = -1e4


def extract_overlap_windows_ceil(x, window_size: int, overlap_win_size: int):
    """(B, H, W, C) -> (B * nW, ow * ow, C): the ow-windows at stride ws,
    zero outside the image, padded by (ow - ws + 1) // 2 on each side (the
    reference's ceil padding; the fork's OCAB floors it)."""
    b, h, w, c = x.shape
    ow = overlap_win_size
    pad = (ow - window_size + 1) // 2
    cols = F.unfold(x.permute(0, 3, 1, 2), ow, stride=window_size,
                    padding=pad)                       # (B, C*ow*ow, L)
    cols = cols.reshape(b, c, ow * ow, -1).permute(0, 3, 2, 1)
    return cols.reshape(-1, ow * ow, c)


def topk_keep(score, k_keep: int):
    """(BW, Nk) bool: the keys at or above the k-th largest score of their
    window, ties at it all kept (JAX's ``lax.top_k`` threshold)."""
    return score >= torch.topk(score, k_keep, dim=-1).values[:, -1:]


class SpatialGateDConvFFN(nn.Module):
    """fc1 -> [depthwise k x k on the first half | gate] -> concat(first *
    act(gate), gate) -> fc2; ``act_layer`` ``gelu`` or ``silu``."""

    def __init__(self, dim: int, mlp_ratio: float = 2.0,
                 dw_kernel_size: int = 3, act_layer: str = "gelu"):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        if hidden % 2:
            raise ValueError(f"hidden width {hidden} must be even for the "
                             f"spatial gate")
        k = dw_kernel_size
        self.act = F.silu if act_layer.lower() == "silu" else gelu_exact
        self.fc1 = nn.Linear(dim, hidden)
        self.dw = nn.Conv2d(hidden // 2, hidden // 2, k, 1, k // 2,
                            groups=hidden // 2)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        xa, xb = self.fc1(x).chunk(2, dim=-1)
        return self.fc2(torch.cat([conv_nhwc(self.dw, xa) * self.act(xb),
                                   xb], dim=-1))


class HABX(nn.Module, DropPathBlock):
    """HATX's hybrid block: norm1 -> {ESC conv attention + conv_scale * CAB}
    residual, then the spatial-gate FFN residual; drop path on both
    branches in training mode at a rate above 0. ``num_heads``,
    ``window_size``, ``shift_size`` and ``squeeze_factor`` are taken for the
    options' sake; the conv attention uses none."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 shift_size: int = 0, compress_ratio: int = 3,
                 squeeze_factor: int = 30, conv_scale: float = 0.01,
                 hab_ffn_ratio: float = 2.0, drop_path_rate: float = 0.0,
                 esc_pdim: int = 16, esc_kernel: int = 13):
        super().__init__()
        self.conv_scale = conv_scale
        self.drop_path_rate = drop_path_rate
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.esc_attn = ESCConvAttn(dim, esc_pdim, esc_kernel)
        self.conv_block = CAB(dim, compress_ratio)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = SpatialGateDConvFFN(dim, hab_ffn_ratio, 3)

    def forward(self, x, draws=None):
        """``draws``: (2, B) uniform draws of the two branches' drop path,
        given where :meth:`takes_draws`."""
        rate = self.drop_path_rate if self.takes_draws() else 0.0
        u_attn, u_ffn = draws if rate else (None, None)
        xn = layer_norm(self.norm1, x)
        conv_x = self.conv_block(xn)
        attn_x = drop_path(self.esc_attn(xn), rate, u_attn)
        x = x + attn_x + conv_x * self.conv_scale
        return x + drop_path(self.mlp(layer_norm(self.norm2, x)), rate, u_ffn)


class OCABX(nn.Module):
    """HATX's overlapping cross-attention block (module docstring), then the
    MLP tail; the attention is plain PyTorch."""

    def __init__(self, dim: int, window_size: int, overlap_ratio: float,
                 num_heads: int, mlp_ratio: float = 2.0,
                 esc_enable: bool = False, esc_pdim: int = 16,
                 esc_kernel: int = 13, kv_topk_ratio: float = 1.0,
                 use_focus_bias: bool = False):
        super().__init__()
        ws = window_size
        self.num_heads = num_heads
        self.window_size = ws
        self.overlap_win_size = int(ws * overlap_ratio) + ws
        ow = self.overlap_win_size
        self.esc_enable = esc_enable
        self.kv_topk_ratio = kv_topk_ratio
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.q_proj = nn.Linear(dim, dim)
        self.kv_proj = nn.Linear(dim, 2 * dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((ws + ow - 1) * (ws + ow - 1), num_heads))
        self.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = nn.Sequential(nn.Linear(dim, int(dim * mlp_ratio)),
                                 nn.GELU(),
                                 nn.Linear(int(dim * mlp_ratio), dim))
        if esc_enable:
            self.esc_core = ConvAttnWrapper(dim, esc_pdim, esc_kernel)
            self.esc_plk = nn.Parameter(
                torch.zeros(esc_pdim, esc_pdim, esc_kernel, esc_kernel))
        self.focus_head = (nn.Sequential(nn.Conv2d(dim, dim // 4, 1),
                                         nn.GELU(),
                                         nn.Conv2d(dim // 4, 1, 1))
                           if use_focus_bias else None)
        self.register_buffer(
            "rpi", index_buffer(relative_position_index_oca(ws,
                                                            overlap_ratio)),
            persistent=False)

    def seeded_init(self, generator: torch.Generator) -> None:
        if self.esc_enable:
            orthogonal_oihw(self.esc_plk, generator)

    def forward(self, x):
        b, h, w, c = x.shape
        ws, ow, heads = self.window_size, self.overlap_win_size, \
            self.num_heads
        nq, nk, d = ws * ws, ow * ow, c // heads
        shortcut = x
        xn = layer_norm(self.norm1, x)
        y = self.esc_core(xn, self.esc_plk) if self.esc_enable else xn
        q = self.q_proj(xn)
        kv = self.kv_proj(y)

        qh = window_partition(q, ws).reshape(-1, nq, heads, d).transpose(1, 2)
        kv_windows = extract_overlap_windows_ceil(kv, ws, ow)
        k_windows = kv_windows[..., :c]
        bw = qh.shape[0]
        kh = k_windows.reshape(bw, nk, heads, d).transpose(1, 2)
        vh = kv_windows[..., c:].reshape(bw, nk, heads, d).transpose(1, 2)
        attn = (qh * d ** -0.5) @ kh.transpose(-2, -1)

        focus_k = None
        if self.focus_head is not None:
            fh = self.focus_head
            sal = conv_nhwc(fh[2], gelu_exact(conv_nhwc(fh[0], y)))
            focus_k = torch.tanh(
                extract_overlap_windows_ceil(sal, ws, ow)[..., 0])  # (BW, Nk)
            attn = attn + focus_k[:, None, None, :]
        if self.kv_topk_ratio < 1.0:
            k_keep = max(1, int(self.kv_topk_ratio * nk))
            score = (torch.linalg.vector_norm(k_windows, dim=-1)
                     if focus_k is None else focus_k)
            keep = topk_keep(score, k_keep)
            attn = attn.masked_fill(~keep[:, None, None, :], PRUNED)

        attn = attn + gather_bias(self.relative_position_bias_table,
                                  self.rpi, heads).to(attn.dtype)[None]
        out = torch.softmax(attn, dim=-1) @ vh
        out = out.transpose(1, 2).reshape(-1, ws, ws, c)
        x = self.proj(window_reverse(out, ws, h, w)) + shortcut
        return x + self.mlp[2](gelu_exact(self.mlp[0](
            layer_norm(self.norm2, x))))


class AttenBlocksX(nn.Module):
    """depth x HABX followed by one OCABX; block i has drop-path rate
    ``drop_path_rates[i]`` (0 where the list is empty)."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size: int, compress_ratio: int, squeeze_factor: int,
                 conv_scale: float, overlap_ratio: float,
                 mlp_ratio: float = 2.0, hab_ffn_ratio: float = 2.0,
                 drop_path_rates: Sequence[float] = (), esc_pdim: int = 16,
                 esc_kernel: int = 13, ocab_esc_enable: bool = False,
                 ocab_esc_pdim: int = 16, ocab_esc_kernel: int = 13,
                 kv_topk_ratio: float = 1.0, use_focus_bias: bool = False):
        super().__init__()
        rates = list(drop_path_rates) or [0.0] * depth
        self.blocks = nn.ModuleList([
            HABX(dim, num_heads, window_size,
                 0 if i % 2 == 0 else window_size // 2, compress_ratio,
                 squeeze_factor, conv_scale, hab_ffn_ratio, rates[i],
                 esc_pdim, esc_kernel)
            for i in range(depth)])
        self.overlap_attn = OCABX(dim, window_size, overlap_ratio, num_heads,
                                  mlp_ratio, ocab_esc_enable, ocab_esc_pdim,
                                  ocab_esc_kernel, kv_topk_ratio,
                                  use_focus_bias)

    def forward(self, x, draws=None):
        """``draws``: (n, 2, B), one (2, B) for each block that takes draws,
        in order."""
        return self.overlap_attn(run_blocks(self.blocks, x, draws))


class RHAGX(DropPathGroup):
    """AttenBlocksX -> 3x3 conv (``1conv``; none otherwise, as in JAX) ->
    + skip."""

    def __init__(self, dim: int, depth: int, resi_connection: str = "1conv",
                 **blocks):
        super().__init__()
        self.residual_group = AttenBlocksX(dim, depth, **blocks)
        self.conv = (nn.Conv2d(dim, dim, 3, 1, 1)
                     if resi_connection == "1conv" else None)

    def forward(self, x, draws=None):
        y = self.residual_group(x, draws)
        if self.conv is not None:
            y = conv_nhwc(self.conv, y)
        return y + x


@ARCH_REGISTRY.register()
class HATX(HATShell):
    """HATX: NHWC RGB in [0, 1] -> NHWC upscaled RGB through the
    ``pixelshuffle`` tail (x2, x3, x4; any other ``upscale`` raises).
    ``drop_path_rate`` and ``use_checkpoint`` act in training mode only;
    ``forward(x, generator=g)`` draws the drop path from ``g``
    (``arch_util.SRShell.run_layers``). ``upsampler is taken for the options'
    sake, as in JAX: the tail is always the pixel shuffle.

    Weights start at torch's defaults; ``models.arch_util.init_weights``
    gives the seeded initialisation, a checkpoint gives trained ones.
    """

    def __init__(self, img_size: int = 64, in_chans: int = 3,
                 embed_dim: int = 96, depths: Sequence[int] = (6, 6, 6, 6),
                 num_heads: Sequence[int] = (6, 6, 6, 6),
                 window_size: int = 7, compress_ratio: int = 3,
                 squeeze_factor: int = 30, conv_scale: float = 0.01,
                 overlap_ratio: float = 0.5, mlp_ratio: float = 2.0,
                 hab_ffn_ratio: float = 2.0, drop_path_rate: float = 0.1,
                 patch_norm: bool = True, upscale: int = 2,
                 img_range: float = 1.0, upsampler: str = "pixelshuffle",
                 resi_connection: str = "1conv", esc_pdim: int = 16,
                 esc_kernel: int = 13, ocab_esc_enable: bool = False,
                 ocab_esc_pdim: int = 16, ocab_esc_kernel: int = 13,
                 kv_topk_ratio: float = 1.0, use_focus_bias: bool = False,
                 use_checkpoint: bool = False):
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        starts = np.cumsum([0, *depths]).tolist()
        layers = [
            RHAGX(embed_dim, depth, resi_connection,
                  num_heads=num_heads[i], window_size=window_size,
                  compress_ratio=compress_ratio,
                  squeeze_factor=squeeze_factor, conv_scale=conv_scale,
                  overlap_ratio=overlap_ratio, mlp_ratio=mlp_ratio,
                  hab_ffn_ratio=hab_ffn_ratio,
                  drop_path_rates=dpr[starts[i]:starts[i] + depth],
                  esc_pdim=esc_pdim, esc_kernel=esc_kernel,
                  ocab_esc_enable=ocab_esc_enable,
                  ocab_esc_pdim=ocab_esc_pdim,
                  ocab_esc_kernel=ocab_esc_kernel,
                  kv_topk_ratio=kv_topk_ratio, use_focus_bias=use_focus_bias)
            for i, depth in enumerate(depths)]
        # JAX's HATX keeps its body conv whatever resi_connection says
        super().__init__(layers, in_chans, embed_dim, window_size,
                         overlap_ratio, patch_norm, upscale, img_range,
                         "pixelshuffle", "1conv", 0)
        self.use_checkpoint = use_checkpoint
