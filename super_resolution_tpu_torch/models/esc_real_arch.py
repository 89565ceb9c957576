"""ESC-Real and ESC-RealM, the real-world ESC variants, NHWC (port of
super_resolution_tpu/models/esc_real_arch.py).

ESC-Real stacks ESC blocks with a LayerNorm before every conv block
(:class:`esc_arch.Block` with ``use_ln``), adds a 7 x 7 depthwise skip from
the input (:class:`InputSkip`) and upsamples x4 with a nearest + conv stack
(:class:`NearestConvHead`) or the DySample resampler (:class:`DySample`).
ESC-RealM puts a pixel-unshuffle stem before the blocks at x1 and x2 and
takes any head of :class:`UniUpsampleHead`. The window attention is ESC's,
its kernel picked by :func:`esc_arch.esc_attention_route`
(``fused_attention`` at window 32, head dim 16).

Module names follow the torch checkpoints as the JAX package's converter
maps them: the Sequential children keep their indices (``skip.0``,
``to_img.1``, ``proj.1``), DySample its ``offset``, ``scope`` and
``end_conv``. DySample's ``init_pos`` buffer is derived, not loaded.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from super_resolution_tpu_torch.models.arch_util import conv_nhwc
from super_resolution_tpu_torch.models.esc_arch import (Block, geo_ensemble,
                                                        orthogonal_oihw)
from super_resolution_tpu_torch.ops.grid_sample import grid_sample_bilinear
from super_resolution_tpu_torch.ops.pixelshuffle import (pixel_shuffle,
                                                         pixel_unshuffle)
from super_resolution_tpu_torch.utils.registry import ARCH_REGISTRY


def _conv(cin: int, cout: int, k: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, 1, k // 2)


def nearest_up(x, r: int):
    """Nearest-neighbour upsample of an NHWC tensor by r."""
    return x.repeat_interleave(r, dim=1).repeat_interleave(r, dim=2)


def _lrelu(x, slope: float):
    return F.leaky_relu(x, negative_slope=slope)


class DySample(nn.Module):
    """Learning to upsample by learning to sample: per-group ``offset`` and
    ``scope`` heads (1 x 1 convs) move each output pixel's sampling point
    around its sub-pixel position, and the input is sampled there
    bilinearly (border padding, ``align_corners=False``), then mixed by the
    1 x 1 ``end_conv``. The sampling runs in float32 whatever the
    activations' dtype: in bf16 a normalised coordinate keeps 8 bits, a
    pixel's worth at 128 pixels."""

    def __init__(self, in_channels: int, out_ch: int, scale: int = 2,
                 groups: int = 4, end_convolution: bool = True):
        super().__init__()
        if in_channels < groups or in_channels % groups:
            raise ValueError(f"DySample: {in_channels} channels in "
                             f"{groups} groups")
        self.scale, self.groups = scale, groups
        out_channels = 2 * groups * scale ** 2
        self.offset = nn.Conv2d(in_channels, out_channels, 1)
        self.scope = nn.Conv2d(in_channels, out_channels, 1, bias=False)
        self.end_conv = (nn.Conv2d(in_channels, out_ch, 1)
                         if end_convolution else None)
        # the sub-pixel positions, (2 * groups * scale^2,) in torch's channel
        # order (x block, then y), as odd numerators over 2 * scale: an
        # integer buffer keeps its values when the module is cast
        h = np.arange(-scale + 1, scale, 2)
        mesh = np.stack(np.meshgrid(h, h, indexing="ij")).transpose(0, 2, 1)
        init = np.tile(mesh.reshape(2, 1, scale, scale), (1, groups, 1, 1))
        self.register_buffer("pos_num", torch.from_numpy(init.reshape(-1)),
                             persistent=False)

    def forward(self, x):
        b, h, w, cin = x.shape
        s, g = self.scale, self.groups
        init_pos = self.pos_num.float() / (2.0 * s)
        offset = (conv_nhwc(self.offset, x).float()
                  * torch.sigmoid(conv_nhwc(self.scope, x).float()) * 0.5
                  + init_pos)                                # (B,H,W,2gs^2)
        off = offset.reshape(b, h, w, 2, g * s * s)
        base_x = torch.arange(w, device=x.device, dtype=torch.float32) + 0.5
        base_y = torch.arange(h, device=x.device, dtype=torch.float32) + 0.5
        px = (base_x[None, None, :, None] + off[..., 0, :]) / w * 2 - 1
        py = (base_y[None, :, None, None] + off[..., 1, :]) / h * 2 - 1
        grid = torch.stack([pixel_shuffle(px, s), pixel_shuffle(py, s)], -1)
        grid = grid.permute(0, 3, 1, 2, 4).reshape(b * g, s * h, s * w, 2)
        xg = x.float().reshape(b, h, w, g, cin // g).permute(0, 3, 1, 2, 4)
        out = grid_sample_bilinear(xg.reshape(b * g, h, w, cin // g), grid)
        out = out.reshape(b, g, s * h, s * w, cin // g).permute(0, 2, 3, 1, 4)
        out = out.reshape(b, s * h, s * w, cin).to(x.dtype)
        if self.end_conv is not None:
            out = conv_nhwc(self.end_conv, out)
        return out


class InputSkip(nn.Module):
    """The skip from the input: 1 x 1 -> 7 x 7 depthwise on a reflect pad ->
    leaky ReLU 0.2 -> 1 x 1, under the Sequential's indices (0, 1, 3; 1, 2,
    4 after a pixel unshuffle by ``prefix_unshuffle``)."""

    def __init__(self, dim: int, prefix_unshuffle: int = 0):
        super().__init__()
        self.prefix_unshuffle = prefix_unshuffle
        d2, cin = dim * 2, 3 * max(prefix_unshuffle, 1) ** 2
        base = 1 if prefix_unshuffle else 0
        self._names = (str(base), str(base + 1), str(base + 3))
        for name, conv in zip(self._names, (
                nn.Conv2d(cin, d2, 1), nn.Conv2d(d2, d2, 7, groups=d2),
                nn.Conv2d(d2, dim, 1))):
            self.add_module(name, conv)

    def forward(self, x):
        conv_a, conv_dw, conv_b = (self._modules[n] for n in self._names)
        if self.prefix_unshuffle:
            x = pixel_unshuffle(x, self.prefix_unshuffle)
        x = conv_nhwc(conv_a, x).permute(0, 3, 1, 2)
        x = F.pad(x, (3, 3, 3, 3), mode="reflect").permute(0, 2, 3, 1)
        x = _lrelu(conv_nhwc(conv_dw, x), 0.2)
        return conv_nhwc(conv_b, x)


class NearestConvHead(nn.Sequential):
    """The x4 head: nearest x2 -> conv -> lrelu -> nearest x2 -> conv ->
    lrelu -> conv -> lrelu -> conv to RGB, the convs at the Sequential's
    indices 1, 4, 6, 8."""

    def __init__(self, dim: int):
        act = nn.LeakyReLU(0.2)
        super().__init__(nn.Identity(), _conv(dim, dim, 3), act, nn.Identity(),
                         _conv(dim, dim, 3), act, _conv(dim, dim, 3), act,
                         _conv(dim, 3, 3))

    def forward(self, x):
        x = _lrelu(conv_nhwc(self[1], nearest_up(x, 2)), 0.2)
        x = _lrelu(conv_nhwc(self[4], nearest_up(x, 2)), 0.2)
        x = _lrelu(conv_nhwc(self[6], x), 0.2)
        return conv_nhwc(self[8], x)


@ARCH_REGISTRY.register()
class ESCReal(nn.Module):
    """ESC-Real network: NHWC RGB in [0, 1] -> NHWC upscaled RGB. 3 x 3
    proj -> n_blocks x ESC Block with LayerNorms (sharing one geo-ensembled
    13 x 13 filter) -> 3 x 3 last + skip + :class:`InputSkip` -> the x4
    nearest + conv head, or :class:`DySample` at ``upscaling_factor``.
    ``attn_type`` selects nothing."""

    def __init__(self, dim: int, pdim: int, kernel_size: int, n_blocks: int,
                 conv_blocks: int, window_size: int, num_heads: int,
                 upscaling_factor: int, exp_ratio: float = 2.0,
                 attn_type: str = "xla", use_dysample: bool = False):
        super().__init__()
        if attn_type not in ("xla", "pallas"):
            raise ValueError(f"attn_type {attn_type!r}: 'xla' or 'pallas'")
        if not use_dysample and upscaling_factor != 4:
            raise ValueError("nearest+conv ESCReal head is x4 (reference)")
        self.upscaling_factor = upscaling_factor
        self.plk_filter = nn.Parameter(
            torch.zeros(pdim, pdim, kernel_size, kernel_size))
        self.proj = _conv(3, dim, 3)
        self.blocks = nn.ModuleList([
            Block(dim, pdim, conv_blocks, 13, window_size, num_heads,
                  exp_ratio, use_ln=True)
            for _ in range(n_blocks)])
        self.last = _conv(dim, dim, 3)
        self.skip = InputSkip(dim)
        self.to_img = (DySample(dim, 3, upscaling_factor, 4)
                       if use_dysample else NearestConvHead(dim))

    def seeded_init(self, generator: torch.Generator) -> None:
        orthogonal_oihw(self.plk_filter, generator)

    def forward(self, x):
        feat = conv_nhwc(self.proj, x).contiguous()
        skip = feat
        plk = geo_ensemble(self.plk_filter)
        for block in self.blocks:
            feat = block(feat, plk)
        feat = conv_nhwc(self.last, feat) + skip + self.skip(x)
        return self.to_img(feat)


class UniUpsampleHead(nn.Sequential):
    """The head family of ESC-RealM: ``conv`` (also any head at x1),
    ``pixelshuffledirect``, ``pixelshuffle``, ``nearest+conv`` and
    ``dysample``, each a Sequential whose layers without parameters keep
    their indices."""

    def __init__(self, upsample: str, scale: int, in_dim: int,
                 out_dim: int = 3, mid_dim: int = 64, group: int = 4):
        steps = []   # (kind, module)

        def conv(cin, cout):
            steps.append(("conv", _conv(cin, cout, 3)))

        def op(kind, arg=None):
            steps.append((kind, nn.Identity() if arg is None else arg))

        pow2 = (scale & (scale - 1)) == 0
        if scale == 1 or upsample == "conv":
            conv(in_dim, out_dim)
        elif upsample == "pixelshuffledirect":
            conv(in_dim, out_dim * scale ** 2)
            op("shuffle", nn.PixelShuffle(scale))
        elif upsample == "pixelshuffle":
            conv(in_dim, mid_dim)
            op("lrelu01")
            if pow2:
                for _ in range(int(math.log2(scale))):
                    conv(mid_dim, 4 * mid_dim)
                    op("shuffle", nn.PixelShuffle(2))
            elif scale == 3:
                conv(mid_dim, 9 * mid_dim)
                op("shuffle", nn.PixelShuffle(3))
            conv(mid_dim, out_dim)
        elif upsample == "nearest+conv":
            if pow2 or scale == 3:
                for _ in range(int(math.log2(scale)) if pow2 else 1):
                    conv(in_dim, in_dim)
                    op("nearest", nn.Upsample(scale_factor=2 if pow2 else 3))
                    op("lrelu02")
                conv(in_dim, in_dim)
                op("lrelu02")
            conv(in_dim, out_dim)
        elif upsample == "dysample":
            dys_dim = in_dim
            if mid_dim != in_dim:
                conv(in_dim, mid_dim)
                op("lrelu01")
                dys_dim = mid_dim
            steps.append(("dysample", DySample(dys_dim, out_dim, scale,
                                               group)))
        else:
            raise ValueError(f"Invalid upsampler {upsample}")
        super().__init__(*(m for _, m in steps))
        self.kinds = [kind for kind, _ in steps]

    def forward(self, x):
        for kind, mod in zip(self.kinds, self):
            if kind == "conv":
                x = conv_nhwc(mod, x)
            elif kind == "dysample":
                x = mod(x)
            elif kind == "shuffle":
                x = pixel_shuffle(x, mod.upscale_factor)
            elif kind == "nearest":
                x = nearest_up(x, int(mod.scale_factor))
            else:
                x = _lrelu(x, 0.01 if kind == "lrelu01" else 0.2)
        return x


@ARCH_REGISTRY.register()
class ESCRealM(nn.Module):
    """Multi-scale ESC-Real: at x1 and x2 (with ``unshuffle_mod``) the input
    is reflect-padded to a multiple of 4 // scale and pixel-unshuffled by it
    before the 3 x 3 proj, and the head upsamples x4; then ESC-Real's body
    and a :class:`UniUpsampleHead`, and the output is cropped to the input's
    size times the scale."""

    def __init__(self, dim: int, pdim: int, kernel_size: int, n_blocks: int,
                 conv_blocks: int, window_size: int, num_heads: int,
                 upscaling_factor: int, exp_ratio: float = 2.0,
                 attn_type: str = "xla", mid_dim: int = 48,
                 upsampler: str = "nearest+conv", unshuffle_mod: bool = True):
        super().__init__()
        if attn_type not in ("xla", "pallas"):
            raise ValueError(f"attn_type {attn_type!r}: 'xla' or 'pallas'")
        self.upscaling_factor = upscaling_factor
        self.plk_filter = nn.Parameter(
            torch.zeros(pdim, pdim, kernel_size, kernel_size))
        up_factor = upscaling_factor
        if unshuffle_mod and upscaling_factor < 3:
            self.unshuffle_factor = 4 // upscaling_factor
            up_factor = 4
            cin = 3 * self.unshuffle_factor ** 2
            self.proj = nn.Sequential(nn.PixelUnshuffle(self.unshuffle_factor),
                                      _conv(cin, dim, 3))
        else:
            self.unshuffle_factor = 0
            self.proj = _conv(3, dim, 3)
        self.skip = InputSkip(dim, prefix_unshuffle=self.unshuffle_factor)
        self.blocks = nn.ModuleList([
            Block(dim, pdim, conv_blocks, 13, window_size, num_heads,
                  exp_ratio, use_ln=True)
            for _ in range(n_blocks)])
        self.last = _conv(dim, dim, 3)
        self.to_img = UniUpsampleHead(upsampler, up_factor, dim, 3, mid_dim,
                                      4)

    def seeded_init(self, generator: torch.Generator) -> None:
        orthogonal_oihw(self.plk_filter, generator)

    def forward(self, x):
        h, w = x.shape[1], x.shape[2]
        p = self.unshuffle_factor
        if p:
            pad_h, pad_w = (p - h % p) % p, (p - w % p) % p
            if pad_h or pad_w:
                x = F.pad(x.permute(0, 3, 1, 2), (0, pad_w, 0, pad_h),
                          mode="reflect").permute(0, 2, 3, 1)
            feat = conv_nhwc(self.proj[1], pixel_unshuffle(x, p))
        else:
            feat = conv_nhwc(self.proj, x)
        feat = feat.contiguous()
        skip = feat
        plk = geo_ensemble(self.plk_filter)
        for block in self.blocks:
            feat = block(feat, plk)
        feat = conv_nhwc(self.last, feat) + skip + self.skip(x)
        out = self.to_img(feat)
        s = self.upscaling_factor
        return out[:, :h * s, :w * s, :]
