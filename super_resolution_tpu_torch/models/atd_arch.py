"""ATD, Adaptive Token Dictionary SR, NHWC (port of
super_resolution_tpu/models/atd_arch.py).

Each layer combines three attentions over one shared qkv projection:

- (S)W-MSA with relative position bias (``WindowAttentionATD``);
- ATD-CA: cross attention of all pixels against a learned per-block token
  dictionary with normalised q and k and a learnable temperature;
- AC-MSA: pixels are categorised by the argmax of their dictionary
  similarity, sorted (stably) into groups of ``category_size`` and attend
  within their group;

followed by a ConvFFN and, except in the last layer of a block, a
refinement of the token dictionary from an instance-normalised similarity
map.

Module and parameter names follow the torch checkpoints
(``layers.0.residual_group.layers.1.attn_atd.scale``,
``...attn_aca.logit_scale``, ``...norm3.weight``, ``...sigma``,
``layers.0.residual_group.td``), so a state_dict with the official names
loads with ``strict=True``.

On the card every layer sends the (S)W-MSA through ``fused_msa_attention``
(``ops/cuda_window_attention.py``), which launches its CUDA kernel or
raises a ``ValueError`` that names the limit, through its autograd entry
``fused_msa_attention_ad`` (the kernel forward, autograd through the plain
version backward: the arb ATD encoder trains); the network pads its input
to a window multiple first. A CPU tensor takes the windowed plain path.
The roll of a shifted layer stays outside the kernel: AC-MSA reads the
same qkv image unrolled.

Precision in bf16: the dictionary similarity (normalisation, product,
softmax) and both attentions' scores and softmax are float32, so the
argmax that sorts the pixels sees float32 values; products with v run in
the working dtype.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from super_resolution_tpu_torch.models.arch_util import (LN_EPS,
                                                         DepthwiseConvFFN,
                                                         KernelOperands,
                                                         SRShell, conv_nhwc,
                                                         gather_bias,
                                                         index_buffer,
                                                         layer_norm)
from super_resolution_tpu_torch.ops.attention import (
    attention_with_bias, relative_position_index_sa, shift_attn_mask_tensor)
from super_resolution_tpu_torch.ops.cuda_build import use_kernel
from super_resolution_tpu_torch.ops.cuda_window_attention import \
    fused_msa_attention_ad
from super_resolution_tpu_torch.ops.windowing import (window_partition,
                                                      window_reverse)
from super_resolution_tpu_torch.utils.registry import ARCH_REGISTRY


class ConvFFNATD(DepthwiseConvFFN):
    """fc1 -> GELU -> (+ k x k depthwise conv, GELU) -> fc2."""


class WindowAttentionATD(nn.Module):
    """W-MSA over pre-projected qkv windows: the parameters (RPB table,
    output projection), and the plain computation for shapes the fused
    route does not take."""

    def __init__(self, dim: int, window_size: int, num_heads: int):
        super().__init__()
        ws = window_size
        self.num_heads = num_heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * ws - 1) * (2 * ws - 1), num_heads))
        self.proj = nn.Linear(dim, dim)
        self.register_buffer(
            "rpi", index_buffer(relative_position_index_sa(ws)),
            persistent=False)

    def bias(self) -> torch.Tensor:
        """(heads, N, N) float32 RPB."""
        return gather_bias(self.relative_position_bias_table, self.rpi,
                           self.num_heads)

    def forward(self, qkv_windows, mask=None):
        """qkv_windows: (B * nW, N, 3C); mask: (nW, N, N) or None."""
        bw, n, c3 = qkv_windows.shape
        c, h = c3 // 3, self.num_heads
        d = c // h
        q, k, v = qkv_windows.reshape(bw, n, 3, h, d).permute(2, 0, 3, 1, 4)
        bias = self.bias()
        if mask is not None:
            nw = mask.shape[0]
            shape = (bw // nw, nw, h, n, d)
            out = attention_with_bias(
                q.reshape(shape), k.reshape(shape), v.reshape(shape),
                bias[None, None] + mask[None, :, None], scale=d ** -0.5)
            out = out.reshape(bw, h, n, d)
        else:
            out = attention_with_bias(q, k, v, bias, scale=d ** -0.5)
        return self.proj(out.transpose(1, 2).reshape(bw, n, c))


class ATD_CA(nn.Module):
    """Token-dictionary cross attention. Returns the attended tokens and
    the (B, n, num_tokens) float32 similarity map."""

    def __init__(self, dim: int, num_tokens: int = 64, reducted_dim: int = 10):
        super().__init__()
        self.num_tokens = num_tokens
        self.wq = nn.Linear(dim, reducted_dim)
        self.wk = nn.Linear(dim, reducted_dim)
        self.wv = nn.Linear(dim, dim)
        self.scale = nn.Parameter(torch.full((num_tokens,), 0.5))

    def forward(self, x, td):
        """x: (B, n, C) normed pixels; td: (B, num_tokens, C)."""
        q = F.normalize(self.wq(x).float(), dim=-1)
        k = F.normalize(self.wk(td).float(), dim=-1)
        v = self.wv(td)
        attn = q @ k.transpose(-1, -2)
        s = self.scale.float().clamp(0, 1)
        attn = torch.softmax(attn * (1 + s * math.log(self.num_tokens)), -1)
        return attn.to(v.dtype) @ v, attn


class AC_MSA(nn.Module):
    """Adaptive category MSA: sort the pixels by the argmax of their
    dictionary similarity into groups of ``category_size`` and attend
    within groups; the last group is filled up with a mirror image of the
    sorted sequence's tail."""

    def __init__(self, dim: int, num_tokens: int = 64, num_heads: int = 4,
                 category_size: int = 128):
        super().__init__()
        self.num_heads = num_heads
        self.category_size = category_size
        self.proj = nn.Linear(dim, dim)
        self.logit_scale = nn.Parameter(
            torch.full((1, 1), math.log(10.0)))

    @staticmethod
    def categorise(sim):
        """(tk_id, order, reverse): each pixel's token, the stable sort of
        the pixels by token, and its inverse permutation."""
        tk_id = sim.argmax(-1)
        order = torch.argsort(tk_id, dim=-1, stable=True)
        return tk_id, order, torch.argsort(order, dim=-1)

    def forward(self, qkv, sim):
        """qkv: (B, n, 3C), unrolled; sim: (B, n, num_tokens)."""
        b, n, c3 = qkv.shape
        c, h = c3 // 3, self.num_heads
        d = c // h
        gs = min(n, self.category_size)
        ng = (n + gs - 1) // gs
        pad_n = ng * gs - n
        _, order, reverse = self.categorise(sim)
        shuffled = qkv.gather(1, order[..., None].expand(-1, -1, c3))
        if pad_n:
            shuffled = torch.cat(
                [shuffled, shuffled[:, n - pad_n:].flip(1)], 1)
        q, k, v = shuffled.reshape(b, ng, gs, 3, h, d).permute(
            3, 0, 1, 4, 2, 5)                           # (B, ng, h, gs, d)
        scale = self.logit_scale.float().clamp(max=math.log(100.0)).exp()
        attn = (q.float() @ k.float().transpose(-1, -2)) * scale
        attn = torch.softmax(attn, -1)
        out = (attn.to(v.dtype) @ v).transpose(2, 3).reshape(
            b, ng * gs, c)[:, :n]
        out = out.gather(1, reverse[..., None].expand(-1, -1, c))
        return self.proj(out)


class InstanceNorm1dTokens(nn.InstanceNorm1d):
    """``nn.InstanceNorm1d(num_tokens, affine=True)`` over (B, m, n), with
    float32 statistics."""

    def __init__(self, num_tokens: int):
        super().__init__(num_tokens, eps=1e-5, affine=True)

    def forward(self, x):
        return F.instance_norm(x.float(), weight=self.weight.float(),
                               bias=self.bias.float(), eps=self.eps)


class ATDTransformerLayer(KernelOperands):
    """One ATD layer: shared qkv -> {(S)W-MSA, ATD-CA, AC-MSA}, ConvFFN,
    token-dictionary refinement. Returns (x, td)."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 shift_size: int, category_size: int, num_tokens: int,
                 reducted_dim: int, convffn_kernel_size: int,
                 mlp_ratio: float, is_last: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.shift_size = shift_size
        self.is_last = is_last
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        if not is_last:
            self.norm3 = InstanceNorm1dTokens(num_tokens)
            self.sigma = nn.Parameter(torch.zeros(num_tokens, 1))
        self.wqkv = nn.Linear(dim, 3 * dim)
        self.attn_win = WindowAttentionATD(dim, window_size, num_heads)
        self.attn_atd = ATD_CA(dim, num_tokens, reducted_dim)
        self.attn_aca = AC_MSA(dim, num_tokens, num_heads, category_size)
        self.convffn = ConvFFNATD(dim, int(dim * mlp_ratio),
                                  convffn_kernel_size)

    def _build_operands(self) -> dict:
        return {"bias": self.attn_win.bias()}

    def forward(self, x, td):
        b, h, w, c = x.shape
        n = h * w
        ws, ss = self.window_size, self.shift_size
        heads = self.num_heads
        shortcut = x
        xn = layer_norm(self.norm1, x)
        qkv = self.wqkv(xn)                                  # (B, h, w, 3C)

        x_atd, sim_atd = self.attn_atd(xn.reshape(b, n, c), td)
        x_aca = self.attn_aca(qkv.reshape(b, n, 3 * c), sim_atd)

        mask = None
        shifted_qkv = qkv
        if ss > 0:
            shifted_qkv = torch.roll(qkv, (-ss, -ss), dims=(1, 2))
            mask = shift_attn_mask_tensor(h, w, ws, ss, str(x.device))
        if use_kernel(x):
            out_img = fused_msa_attention_ad(
                shifted_qkv.contiguous(), self.kernel_operands()["bias"],
                mask, heads=heads, window_size=ws,
                scale=(c // heads) ** -0.5)
            x_win = self.attn_win.proj(out_img)
        else:
            qkv_windows = window_partition(shifted_qkv, ws).reshape(
                -1, ws * ws, 3 * c)
            x_win = window_reverse(self.attn_win(qkv_windows, mask).reshape(
                -1, ws, ws, c), ws, h, w)
        if ss > 0:
            x_win = torch.roll(x_win, (ss, ss), dims=(1, 2))

        x = shortcut + x_win + (x_atd + x_aca).reshape(b, h, w, c)
        x = x + self.convffn(layer_norm(self.norm2, x))

        if not self.is_last:
            mask_soft = torch.softmax(
                self.norm3(sim_atd.transpose(-1, -2)), -1)   # (B, m, n)
            s = torch.sigmoid(self.sigma)
            td = s * td + (1 - s) * (mask_soft.to(x.dtype)
                                     @ x.reshape(b, n, c))
        return x, td


class BasicBlockATD(nn.Module):
    """A block's layers and its token dictionary ``td``."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size: int, category_size: int, num_tokens: int,
                 reducted_dim: int, convffn_kernel_size: int,
                 mlp_ratio: float):
        super().__init__()
        self.layers = nn.ModuleList([
            ATDTransformerLayer(
                dim, num_heads, window_size,
                0 if i % 2 == 0 else window_size // 2, category_size,
                num_tokens, reducted_dim, convffn_kernel_size, mlp_ratio,
                is_last=(i == depth - 1))
            for i in range(depth)])
        self.td = nn.Parameter(torch.zeros(num_tokens, dim))

    @torch.no_grad()
    def seeded_init(self, generator: torch.Generator) -> None:
        self.td.copy_(torch.empty(self.td.shape).normal_(
            generator=generator))

    def forward(self, x):
        td = self.td[None].expand(x.shape[0], -1, -1)
        for layer in self.layers:
            x, td = layer(x, td)
        return x


class ATDB(nn.Module):
    """residual_group + conv + skip."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size: int, category_size: int, num_tokens: int,
                 reducted_dim: int, convffn_kernel_size: int,
                 mlp_ratio: float, resi_connection: str = "1conv"):
        super().__init__()
        if resi_connection != "1conv":
            raise NotImplementedError(resi_connection)
        self.residual_group = BasicBlockATD(
            dim, depth, num_heads, window_size, category_size, num_tokens,
            reducted_dim, convffn_kernel_size, mlp_ratio)
        self.conv = nn.Conv2d(dim, dim, 3, 1, 1)

    def forward(self, x):
        return conv_nhwc(self.conv, self.residual_group(x)) + x


@ARCH_REGISTRY.register()
class ATD(SRShell):
    """ATD: shallow conv -> ATDBs -> norm, body conv and global residual ->
    reconstruction (``arch_util.SRShell``, the ``pixelshuffle`` and
    ``pixelshuffledirect`` upsamplers). Input and output are NHWC; an input
    that is no window multiple is padded at the bottom and the right with
    its mirror image (numpy's ``symmetric``).

    Weights start at torch's defaults; ``models.arch_util.init_weights``
    gives the seeded initialisation, a checkpoint gives trained ones.
    """

    def __init__(self, img_size: int = 64, in_chans: int = 3,
                 embed_dim: int = 90,
                 depths: Sequence[int] = (6, 6, 6, 6, 6, 6),
                 num_heads: Sequence[int] = (6, 6, 6, 6, 6, 6),
                 window_size: int = 16, category_size: int = 256,
                 num_tokens: int = 64, reducted_dim: int = 20,
                 convffn_kernel_size: int = 5, mlp_ratio: float = 2.0,
                 patch_norm: bool = True, upscale: int = 4,
                 img_range: float = 1.0, upsampler: str = "pixelshuffle",
                 resi_connection: str = "1conv"):
        if upsampler not in ("pixelshuffle", "pixelshuffledirect"):
            raise NotImplementedError(upsampler)
        layers = [
            ATDB(embed_dim, depth, num_heads[i], window_size, category_size,
                 num_tokens, reducted_dim, convffn_kernel_size, mlp_ratio,
                 resi_connection)
            for i, depth in enumerate(depths)]
        super().__init__(layers, in_chans, embed_dim, window_size, patch_norm,
                         upscale, img_range, upsampler, resi_connection,
                         pad_mode="symmetric")
        # index buffer of the checkpoints, kept so those load strictly;
        # each attention module holds its own copy
        self.register_buffer("relative_position_index_SA", index_buffer(
            relative_position_index_sa(window_size)))
