"""Feature encoders of the arbitrary-scale heads, NHWC (port of
super_resolution_tpu/arb/encoders.py; ref: esc_arb/models/{esc,edsr,swinir,
rdn,rcan,atd,hit_srf}.py with ``no_upsampling``): each SR backbone's trunk
without its reconstruction, ``out_dim`` channels at the input's size. Each
keeps the JAX module's fields exactly (``no_upsampling`` where JAX has it,
no ``scale`` but RCAN's).

They reuse the port's blocks, so on a CUDA tensor they launch the port's
kernels: ``ESCEncoder`` ``fused_attention`` (window 32) through ESC's
``Block``, ``SwinIREncoder`` ``fused_msa_block(_shifted)`` and
``mlp_block``, ``ATDEncoder`` ``fused_msa_attention``, ``HiTSRFEncoder``
``fused_scc_block``, each through its autograd entry so that the heads
train; EDSR, RDN and RCAN are convolutions. ``ESCEncoder.deployment`` says
the large filter was geo-ensembled offline.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from super_resolution_tpu_torch.arb.models import register
from super_resolution_tpu_torch.models.arch_util import (LN_EPS,
                                                         PatchEmbedNorm,
                                                         conv_nhwc,
                                                         layer_norm,
                                                         pad_symmetric)
from super_resolution_tpu_torch.models.atd_arch import ATDB
from super_resolution_tpu_torch.models.cnn_archs import ResidualBlockNoBN
from super_resolution_tpu_torch.models.esc_arch import (Block, geo_ensemble,
                                                        orthogonal_oihw,
                                                        pointwise)
from super_resolution_tpu_torch.models.hitsrf_arch import RHTB
from super_resolution_tpu_torch.models.swinir_arch import RSTB
from super_resolution_tpu_torch.ops.windowing import reflect_pad


def _conv3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, 1, 1)


@register("esc")
class ESCEncoder(nn.Module):
    """ESC's trunk: proj -> blocks (one shared large filter) -> last +
    skip."""

    def __init__(self, dim: int = 64, pdim: int = 16, kernel_size: int = 13,
                 n_blocks: int = 5, conv_blocks: int = 5,
                 window_size: int = 32, num_heads: int = 4,
                 exp_ratio: float = 1.25, deployment: bool = False):
        super().__init__()
        self.out_dim = dim
        self.deployment = deployment
        self.plk_filter = nn.Parameter(
            torch.zeros(pdim, pdim, kernel_size, kernel_size))
        self.proj = _conv3(3, dim)
        self.blocks = nn.ModuleList([
            Block(dim, pdim, conv_blocks, kernel_size, window_size,
                  num_heads, exp_ratio) for _ in range(n_blocks)])
        self.last = _conv3(dim, dim)

    def seeded_init(self, generator: torch.Generator) -> None:
        orthogonal_oihw(self.plk_filter, generator)

    def forward(self, x):
        feat = conv_nhwc(self.proj, x).contiguous()
        skip = feat
        plk = (self.plk_filter if self.deployment
               else geo_ensemble(self.plk_filter))
        for block in self.blocks:
            feat = block(feat, plk)
        return conv_nhwc(self.last, feat) + skip


@register("edsr-baseline")
@register("edsr")
class EDSREncoder(nn.Module):
    """EDSR's trunk: head -> residual blocks -> body_tail + head."""

    def __init__(self, n_resblocks: int = 16, n_feats: int = 64,
                 res_scale: float = 1.0, no_upsampling: bool = True,
                 rgb_range: float = 1.0):
        super().__init__()
        self.out_dim = n_feats
        self.head = _conv3(3, n_feats)
        self.body = nn.ModuleList([ResidualBlockNoBN(n_feats, res_scale)
                                   for _ in range(n_resblocks)])
        self.body_tail = _conv3(n_feats, n_feats)

    def forward(self, x):
        feat = conv_nhwc(self.head, x)
        res = feat
        for blk in self.body:
            res = blk(res)
        return conv_nhwc(self.body_tail, res) + feat


@register("swinir")
class SwinIREncoder(nn.Module):
    """SwinIR's trunk: reflect pad to the window, conv_first -> RSTBs ->
    norm -> conv_after_body + skip, crop."""

    def __init__(self, embed_dim: int = 60,
                 depths: Sequence[int] = (6, 6, 6, 6),
                 num_heads: Sequence[int] = (6, 6, 6, 6),
                 window_size: int = 8, mlp_ratio: float = 2.0):
        super().__init__()
        self.out_dim = embed_dim
        self.window_size = window_size
        self.conv_first = _conv3(3, embed_dim)
        self.layers = nn.ModuleList([
            RSTB(embed_dim, d, num_heads[i], window_size, mlp_ratio)
            for i, d in enumerate(depths)])
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.conv_after_body = _conv3(embed_dim, embed_dim)

    def forward(self, x):
        h, w = x.shape[1], x.shape[2]
        ws = self.window_size
        x = reflect_pad(x, (ws - h % ws) % ws, (ws - w % ws) % ws)
        feat = conv_nhwc(self.conv_first, x).contiguous()
        body = feat
        for layer in self.layers:
            body = layer(body)
        out = conv_nhwc(self.conv_after_body,
                        layer_norm(self.norm, body)) + feat
        return out[:, :h, :w, :]


class _RDBConv(nn.Module):
    """conv + ReLU, concatenated to its input (ref: rdn.py:13-25)."""

    def __init__(self, cin: int, grow: int):
        super().__init__()
        self.conv = nn.Sequential(_conv3(cin, grow), nn.ReLU())

    def forward(self, x):
        return torch.cat([x, F.relu(conv_nhwc(self.conv[0], x))], dim=-1)


class _RDB(nn.Module):
    """Residual dense block: n_convs dense convs -> 1 x 1 LFF + input."""

    def __init__(self, g0: int, grow: int, n_convs: int):
        super().__init__()
        self.convs = nn.Sequential(*[_RDBConv(g0 + i * grow, grow)
                                     for i in range(n_convs)])
        self.LFF = nn.Conv2d(g0 + n_convs * grow, g0, 1)

    def forward(self, x):
        return pointwise(self.LFF, self.convs(x)) + x


@register("rdn")
class RDNEncoder(nn.Module):
    """RDN's trunk (ref: rdn.py:45-100), config ``A`` (20 blocks of 6
    convs, growth 32) or ``B`` (16 of 8, growth 64); ``RDNkSize`` is taken
    and 3 used, as in JAX."""

    def __init__(self, G0: int = 64, RDNkSize: int = 3,
                 RDNconfig: str = "B"):
        super().__init__()
        d, c, g = {"A": (20, 6, 32), "B": (16, 8, 64)}[RDNconfig]
        self.out_dim = G0
        self.SFENet1 = _conv3(3, G0)
        self.SFENet2 = _conv3(G0, G0)
        self.RDBs = nn.ModuleList([_RDB(G0, g, c) for _ in range(d)])
        self.GFF = nn.Sequential(nn.Conv2d(d * G0, G0, 1), _conv3(G0, G0))

    def forward(self, x):
        f1 = conv_nhwc(self.SFENet1, x)
        y = conv_nhwc(self.SFENet2, f1)
        outs = []
        for rdb in self.RDBs:
            y = rdb(y)
            outs.append(y)
        y = pointwise(self.GFF[0], torch.cat(outs, dim=-1))
        return conv_nhwc(self.GFF[1], y) + f1


class _RCANCALayer(nn.Module):
    """Channel attention: mean -> 1 x 1 -> ReLU -> 1 x 1 -> sigmoid gate
    (ref: rcan.py:46-62)."""

    def __init__(self, channel: int, reduction: int = 16):
        super().__init__()
        self.conv_du = nn.Sequential(
            nn.Conv2d(channel, channel // reduction, 1), nn.ReLU(),
            nn.Conv2d(channel // reduction, channel, 1), nn.Sigmoid())

    def forward(self, x):
        y = F.relu(pointwise(self.conv_du[0], x.mean(dim=(1, 2),
                                                     keepdim=True)))
        return x * torch.sigmoid(pointwise(self.conv_du[2], y))


class _RCAB(nn.Module):
    """conv -> ReLU -> conv -> channel attention, + input (ref:
    rcan.py:64-84)."""

    def __init__(self, n_feat: int, reduction: int):
        super().__init__()
        self.body = nn.Sequential(_conv3(n_feat, n_feat), nn.ReLU(),
                                  _conv3(n_feat, n_feat),
                                  _RCANCALayer(n_feat, reduction))

    def forward(self, x):
        res = conv_nhwc(self.body[2], F.relu(conv_nhwc(self.body[0], x)))
        return self.body[3](res) + x


class _RCANResidualGroup(nn.Module):
    """n_resblocks RCABs -> conv, + input (ref: rcan.py:86-102)."""

    def __init__(self, n_feat: int, reduction: int, n_resblocks: int):
        super().__init__()
        self.body = nn.Sequential(*[_RCAB(n_feat, reduction)
                                    for _ in range(n_resblocks)],
                                  _conv3(n_feat, n_feat))

    def forward(self, x):
        res = x
        for blk in self.body[:-1]:
            res = blk(res)
        return conv_nhwc(self.body[-1], res) + x


@register("rcan")
class RCANEncoder(nn.Module):
    """RCAN's trunk (ref: rcan.py:104-207), no mean shift on the arb path;
    ``no_upsampling`` must be set, as JAX asserts."""

    def __init__(self, n_resgroups: int = 10, n_resblocks: int = 20,
                 n_feats: int = 64, reduction: int = 16, scale: int = 2,
                 no_upsampling: bool = True, rgb_range: float = 1.0):
        super().__init__()
        if not no_upsampling:
            raise ValueError("arb encoders run feature-only: "
                             "no_upsampling must be true")
        self.out_dim = n_feats
        self.head = nn.Sequential(_conv3(3, n_feats))
        self.body = nn.Sequential(
            *[_RCANResidualGroup(n_feats, reduction, n_resblocks)
              for _ in range(n_resgroups)], _conv3(n_feats, n_feats))

    def forward(self, x):
        x = conv_nhwc(self.head[0], x)
        res = x
        for group in self.body[:-1]:
            res = group(res)
        return conv_nhwc(self.body[-1], res) + x


@register("ATDLight")
class ATDEncoder(nn.Module):
    """ATD's trunk (ref: atd.py:883-1216): symmetric pad to the window,
    conv_first -> patch norm -> ATDBs -> norm -> conv_after_body + skip,
    crop; no mean shift."""

    def __init__(self, embed_dim: int = 48,
                 depths: Sequence[int] = (6, 6, 6, 6),
                 num_heads: Sequence[int] = (4, 4, 4, 4),
                 window_size: int = 16, category_size: int = 128,
                 num_tokens: int = 64, reducted_dim: int = 8,
                 convffn_kernel_size: int = 7, mlp_ratio: float = 1.0,
                 no_upsampling: bool = True):
        super().__init__()
        self.out_dim = embed_dim
        self.window_size = window_size
        self.conv_first = _conv3(3, embed_dim)
        self.patch_embed = PatchEmbedNorm(embed_dim, True)
        self.layers = nn.ModuleList([
            ATDB(embed_dim, depths[i], num_heads[i], window_size,
                 category_size, num_tokens, reducted_dim,
                 convffn_kernel_size, mlp_ratio, "1conv")
            for i in range(len(depths))])
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.conv_after_body = _conv3(embed_dim, embed_dim)

    def forward(self, x):
        h, w = x.shape[1], x.shape[2]
        mod = self.window_size
        x = pad_symmetric(x, (mod - h % mod) % mod, (mod - w % mod) % mod)
        feat = conv_nhwc(self.conv_first, x).contiguous()
        body = self.patch_embed(feat)
        for layer in self.layers:
            body = layer(body)
        feat = conv_nhwc(self.conv_after_body,
                         layer_norm(self.norm, body)) + feat
        return feat[:, :h, :w]


@register("HiTSRF")
class HiTSRFEncoder(nn.Module):
    """HiT-SRF's trunk (ref: hit_srf.py:726-936): conv_first -> patch norm
    -> RHTBs -> norm -> conv_after_body + skip; each block pads its own
    input. No mean shift."""

    def __init__(self, embed_dim: int = 60,
                 depths: Sequence[int] = (6, 6, 6, 6),
                 num_heads: Sequence[int] = (6, 6, 6, 6),
                 base_win_size: Sequence[int] = (8, 8),
                 mlp_ratio: float = 2.0,
                 hier_win_ratios: Sequence[float] = (0.5, 1, 2, 4, 6, 8),
                 no_upsampling: bool = True):
        super().__init__()
        self.out_dim = embed_dim
        self.conv_first = _conv3(3, embed_dim)
        self.patch_embed = PatchEmbedNorm(embed_dim, True)
        self.layers = nn.ModuleList([
            RHTB(embed_dim, depths[i], num_heads[i], tuple(base_win_size),
                 mlp_ratio, tuple(hier_win_ratios))
            for i in range(len(depths))])
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.conv_after_body = _conv3(embed_dim, embed_dim)

    def forward(self, x):
        feat = conv_nhwc(self.conv_first, x).contiguous()
        body = self.patch_embed(feat)
        for layer in self.layers:
            body = layer(body)
        return conv_nhwc(self.conv_after_body,
                         layer_norm(self.norm, body)) + feat
