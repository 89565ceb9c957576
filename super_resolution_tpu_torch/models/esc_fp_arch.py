"""ESC-FP, the fully pipelined ESC variant, NHWC (port of
super_resolution_tpu/models/esc_fp_arch.py).

The 13 x 13 large kernel is decomposed into a channel mix (``lk_channel``,
1 x 1) and a spatial depthwise filter (``lk_spatial``); the per-sample
dynamic 3 x 3 kernel is padded to 13 x 13 and added to the spatial filter,
so one grouped conv does both. The reconstruction adds a bicubic upsample
of the input. The window attention is ESC's (``WindowAttentionESC``, its
kernel picked by :func:`esc_arch.esc_attention_route`: ``fused_attention``
at ESC-FP's window 32 and head dim 16).

Parameter names follow the torch checkpoints as the JAX package's
converter maps them (``lk_channel``, ``lk_spatial``,
``blocks.0.pconvs.0.plk.proj.1``, ``blocks.0.lns.0``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from super_resolution_tpu_torch.models.arch_util import (conv_nhwc,
                                                         gelu_exact,
                                                         layer_norm)
from super_resolution_tpu_torch.models.esc_arch import (ESC_LN_EPS, ConvFFN,
                                                        SplitPointwise,
                                                        WindowAttentionESC,
                                                        orthogonal_oihw)
from super_resolution_tpu_torch.ops.conv import (conv2d_nhwc,
                                                 dynamic_depthwise_conv)
from super_resolution_tpu_torch.ops.pixelshuffle import pixel_shuffle
from super_resolution_tpu_torch.ops.resize import resize_to
from super_resolution_tpu_torch.utils.registry import ARCH_REGISTRY


class DecomposedConvolutionalAttention(nn.Module):
    """On the first ``pdim`` channels: the ``lk_channel`` 1 x 1 mix, then
    one per-sample depthwise conv whose filter is ``lk_spatial`` plus the
    dynamic 3 x 3 kernel padded to its size. The dynamic kernels come from
    a head on the slab's global average, 1 x 1 -> GELU -> 1 x 1 (``proj``,
    under the checkpoints' Sequential names)."""

    def __init__(self, pdim: int, kernel_size: int = 13):
        super().__init__()
        self.pdim = pdim
        self.kernel_size = kernel_size
        self.proj = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Conv2d(pdim, pdim // 4, 1),
            nn.GELU(), nn.Conv2d(pdim // 4, pdim * 9, 1))

    def attended(self, x1, lk_channel, lk_spatial):
        """The processed slab from the compact (B, H, W, pdim) slab."""
        down, up = self.proj[1], self.proj[3]
        g = x1.float().mean(dim=(1, 2)).to(x1.dtype)          # (B, pdim)
        dk = gelu_exact(F.linear(g, down.weight.flatten(1), down.bias))
        dk = F.linear(dk, up.weight.flatten(1), up.bias)      # (B, pdim*9)
        dk = dk.reshape(-1, self.pdim, 3, 3).permute(0, 2, 3, 1)
        n_pad = (self.kernel_size - 3) // 2
        dk = F.pad(dk, (0, 0, n_pad, n_pad, n_pad, n_pad))    # (B, ks, ks, p)
        spatial = lk_spatial[:, 0].permute(1, 2, 0).to(x1.dtype)
        x1 = conv2d_nhwc(x1, lk_channel.to(x1.dtype))
        return dynamic_depthwise_conv(x1, dk + spatial[None])


class DecomposedConvAttnWrapper(nn.Module):
    """DecomposedConvolutionalAttention + the 1 x 1 aggregation over
    [attended slab, passthrough channels] (a :class:`SplitPointwise`: the
    concat is never built)."""

    def __init__(self, dim: int, pdim: int, kernel_size: int = 13):
        super().__init__()
        self.pdim = pdim
        self.plk = DecomposedConvolutionalAttention(pdim, kernel_size)
        self.aggr = SplitPointwise(dim, pdim, dim)

    def forward(self, x, lk_channel, lk_spatial):
        x1 = x[..., :self.pdim].contiguous()
        return self.aggr(self.plk.attended(x1, lk_channel, lk_spatial), x)


class BlockFP(nn.Module):
    """ESC-FP block: ConvFFN proj (ratio 1.5) -> window attention ->
    conv_blocks x (LayerNorm -> ConvFFN -> decomposed conv attention) ->
    LayerNorm -> 3 x 3 conv out, all residual."""

    def __init__(self, dim: int, pdim: int, conv_blocks: int,
                 kernel_size: int, window_size: int, num_heads: int,
                 exp_ratio: float):
        super().__init__()

        def ln():
            return nn.LayerNorm(dim, eps=ESC_LN_EPS)

        self.ln_proj = ln()
        self.proj = ConvFFN(dim, 3, 1.5)
        self.ln_attn = ln()
        self.attn = WindowAttentionESC(dim, window_size, num_heads)
        self.lns = nn.ModuleList([ln() for _ in range(conv_blocks)])
        self.pconvs = nn.ModuleList([
            DecomposedConvAttnWrapper(dim, pdim, kernel_size)
            for _ in range(conv_blocks)])
        self.convffns = nn.ModuleList([ConvFFN(dim, 3, exp_ratio)
                                       for _ in range(conv_blocks)])
        self.ln_out = ln()
        self.conv_out = nn.Conv2d(dim, dim, 3, 1, 1)

    def forward(self, x, lk_channel, lk_spatial):
        skip = x
        x = self.proj(layer_norm(self.ln_proj, x))
        x = x + self.attn(layer_norm(self.ln_attn, x))
        for ln, pconv, convffn in zip(self.lns, self.pconvs, self.convffns):
            x = x + pconv(convffn(layer_norm(ln, x)), lk_channel, lk_spatial)
        x = conv_nhwc(self.conv_out, layer_norm(self.ln_out, x))
        return x + skip


@ARCH_REGISTRY.register()
class ESCFP(nn.Module):
    """ESC-FP network: NHWC RGB in [0, 1] -> NHWC upscaled RGB. 3 x 3 proj
    -> n_blocks x BlockFP (which share ``lk_channel`` and ``lk_spatial``)
    -> LayerNorm -> 3 x 3 last + skip -> to_img conv -> pixel shuffle, plus
    the bicubic upsample of the input.

    ``attn_type`` (``xla`` | ``pallas``) is the backend switch of the option
    files and selects nothing here. Weights start at torch's defaults;
    ``models.arch_util.init_weights`` gives the seeded initialisation.
    """

    def __init__(self, dim: int, pdim: int, kernel_size: int, n_blocks: int,
                 conv_blocks: int, window_size: int, num_heads: int,
                 upscaling_factor: int, exp_ratio: float = 2.0,
                 attn_type: str = "xla"):
        super().__init__()
        if attn_type not in ("xla", "pallas"):
            raise ValueError(f"attn_type {attn_type!r}: 'xla' or 'pallas'")
        self.upscaling_factor = upscaling_factor
        self.lk_channel = nn.Parameter(torch.zeros(pdim, pdim, 1, 1))
        self.lk_spatial = nn.Parameter(
            torch.zeros(pdim, 1, kernel_size, kernel_size))
        self.proj = nn.Conv2d(3, dim, 3, 1, 1)
        self.blocks = nn.ModuleList([
            BlockFP(dim, pdim, conv_blocks, kernel_size, window_size,
                    num_heads, exp_ratio)
            for _ in range(n_blocks)])
        self.ln_last = nn.LayerNorm(dim, eps=ESC_LN_EPS)
        self.last = nn.Conv2d(dim, dim, 3, 1, 1)
        self.to_img = nn.Conv2d(dim, 3 * upscaling_factor ** 2, 3, 1, 1)

    @torch.no_grad()
    def seeded_init(self, generator: torch.Generator) -> None:
        """``lk_channel`` standard normal, ``lk_spatial`` orthogonal, as the
        JAX module initialises them."""
        self.lk_channel.copy_(torch.empty(self.lk_channel.shape).normal_(
            generator=generator))
        orthogonal_oihw(self.lk_spatial, generator)

    def forward(self, x):
        s = self.upscaling_factor
        feat = conv_nhwc(self.proj, x).contiguous()
        skip = feat
        for block in self.blocks:
            feat = block(feat, self.lk_channel, self.lk_spatial)
        feat = conv_nhwc(self.last, layer_norm(self.ln_last, feat)) + skip
        feat = conv_nhwc(self.to_img, feat)
        up = resize_to(x, x.shape[1] * s, x.shape[2] * s, "bicubic")
        return pixel_shuffle(feat, s) + up
