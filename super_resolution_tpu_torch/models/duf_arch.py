"""DUF, dynamic upsampling filters for video SR, NDHWC (port of
super_resolution_tpu/models/duf_arch.py; ref: basicsr/archs/
duf_arch.py:9-276).

3-D dense blocks over the seven-frame clip (``F.conv3d``), a temporal
reduction to one frame, then a per-pixel dynamic 5 x 5 filter bank
(softmax-normalised) applied to the centre frame, plus a residual image,
pixel-shuffled to the target scale. The batch norms use their stored
statistics (the shared ``FrozenBatchNorm``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from super_resolution_tpu_torch.models.discriminator_arch import \
    FrozenBatchNorm
from super_resolution_tpu_torch.ops.conv import shifted_neighborhoods
from super_resolution_tpu_torch.ops.pixelshuffle import pixel_shuffle
from super_resolution_tpu_torch.utils.registry import ARCH_REGISTRY

LAYERS = {16: (3, 32), 28: (9, 16), 52: (21, 16)}


def conv3d(cin: int, cout: int, k, padding) -> nn.Conv3d:
    return nn.Conv3d(cin, cout, k, 1, padding)


def conv3d_ndhwc(conv: nn.Conv3d, x):
    """Apply ``conv`` to (B, T, H, W, C); returns the same layout."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), conv.weight, conv.bias,
                 conv.stride, conv.padding)
    return y.permute(0, 2, 3, 4, 1)


def bn_relu_conv(block: nn.Sequential, x):
    """A dense block's (BN, ReLU, 1x1x1 conv, BN, ReLU, 3x3x3 conv)."""
    y = F.relu(block[0](x))
    y = conv3d_ndhwc(block[2], y)
    y = F.relu(block[3](y))
    return conv3d_ndhwc(block[5], y)


def dense_layer(c: int, grow: int, eps: float, padding) -> nn.Sequential:
    return nn.Sequential(
        FrozenBatchNorm(c, eps, channel_dim=-1), nn.ReLU(),
        conv3d(c, c, 1, 0), FrozenBatchNorm(c, eps, channel_dim=-1),
        nn.ReLU(), conv3d(c, grow, 3, padding))


class DenseBlocks(nn.Module):
    """``num_block`` dense blocks; T stays (ref: duf_arch.py:78-131)."""

    def __init__(self, num_block: int, num_feat: int = 64,
                 num_grow_ch: int = 16, eps: float = 1e-5):
        super().__init__()
        self.dense_blocks = nn.ModuleList(
            dense_layer(num_feat + i * num_grow_ch, num_grow_ch, eps,
                        (1, 1, 1)) for i in range(num_block))

    def forward(self, x):
        for block in self.dense_blocks:
            x = torch.cat([x, bn_relu_conv(block, x)], dim=-1)
        return x


class DenseBlocksTemporalReduce(nn.Module):
    """Three dense blocks, each valid in time: T shrinks by 2 a block (ref:
    duf_arch.py:9-75)."""

    def __init__(self, num_feat: int = 64, num_grow_ch: int = 32,
                 eps: float = 1e-5):
        super().__init__()
        for i in (1, 2, 3):
            setattr(self, f"temporal_reduce{i}", dense_layer(
                num_feat + (i - 1) * num_grow_ch, num_grow_ch, eps,
                (0, 1, 1)))

    def forward(self, x):
        for i in (1, 2, 3):
            y = bn_relu_conv(getattr(self, f"temporal_reduce{i}"), x)
            x = torch.cat([x[:, 1:-1], y], dim=-1)
        return x


def dynamic_upsampling_filter(x, filters, filter_size=(5, 5)):
    """Per-pixel dynamic filtering (ref: duf_arch.py:134-178; JAX
    ``dynamic_upsampling_filter``): x (B, H, W, 3), filters (B, H, W,
    kh * kw, r^2) -> (B, H, W, 3 * r^2), channels c-major for the pixel
    shuffle."""
    taps = shifted_neighborhoods(x, filter_size[0])        # (B,H,W,kk,3)
    out = torch.einsum("bhwkc,bhwku->bhwcu", taps, filters)
    return out.reshape(out.shape[:3] + (-1,))


@ARCH_REGISTRY.register()
class DUF(nn.Module):
    """DUF (ref: duf_arch.py:181-276): (B, 7, H, W, 3) -> the centre frame
    upscaled, (B, scale H, scale W, 3). ``num_layer`` 16, 28 or 52;
    ``adapt_official_weights`` sets the batch norms' eps to 1e-3."""

    def __init__(self, scale: int = 4, num_layer: int = 52,
                 adapt_official_weights: bool = False):
        super().__init__()
        if num_layer not in LAYERS:
            raise ValueError(f"num_layer {num_layer}")
        self.scale = scale
        eps = 1e-3 if adapt_official_weights else 1e-5
        num_block, grow = LAYERS[num_layer]
        self.conv3d1 = conv3d(3, 64, (1, 3, 3), (0, 1, 1))
        self.dense_block1 = DenseBlocks(num_block, 64, grow, eps)
        self.dense_block2 = DenseBlocksTemporalReduce(
            64 + grow * num_block, grow, eps)
        channels = 64 + grow * num_block + grow * 3
        self.bn3d2 = FrozenBatchNorm(channels, eps, channel_dim=-1)
        self.conv3d2 = conv3d(channels, 256, (1, 3, 3), (0, 1, 1))
        self.conv3d_r1 = conv3d(256, 256, 1, 0)
        self.conv3d_r2 = conv3d(256, 3 * scale ** 2, 1, 0)
        self.conv3d_f1 = conv3d(256, 512, 1, 0)
        self.conv3d_f2 = conv3d(512, 25 * scale ** 2, 1, 0)

    def forward(self, x):
        b, t, h, w, c = x.shape
        x_center = x[:, t // 2]
        x = conv3d_ndhwc(self.conv3d1, x)
        x = self.dense_block2(self.dense_block1(x))
        x = F.relu(self.bn3d2(x))
        x = F.relu(conv3d_ndhwc(self.conv3d2, x))
        res = conv3d_ndhwc(self.conv3d_r2,
                           F.relu(conv3d_ndhwc(self.conv3d_r1, x)))
        filt = conv3d_ndhwc(self.conv3d_f2,
                            F.relu(conv3d_ndhwc(self.conv3d_f1, x)))
        filt = torch.softmax(filt.reshape(b, h, w, 25, self.scale ** 2),
                             dim=3)
        out = dynamic_upsampling_filter(x_center, filt) + res[:, 0]
        return pixel_shuffle(out, self.scale)
