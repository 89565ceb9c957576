"""RIDNet, real image denoising with feature attention, NHWC (port of
super_resolution_tpu/models/ridnet_arch.py; ref: basicsr/archs/
ridnet_arch.py:8-180).

Mean shift in and out, a head conv, ``num_block`` enhancement attention
modules (a merge-and-run unit of dilated convs, residual blocks, channel
attention), a tail conv and the input as a global residual. Module names
are BasicSR's (``body.0.merge.dilation1.0``, ``body.0.ca.attention.1``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from super_resolution_tpu_torch.models.arch_util import conv_nhwc
from super_resolution_tpu_torch.models.cnn_archs import ResidualBlockNoBN
from super_resolution_tpu_torch.utils.registry import ARCH_REGISTRY


def conv(cin: int, cout: int, k: int = 3, dilation: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, 1, dilation * (k // 2), dilation)


class MeanShift(nn.Conv2d):
    """A 1 x 1 conv that starts as (x - sign * range * mean) / std (ref:
    ridnet_arch.py:8-28); a trainable conv, as in the reference."""

    def __init__(self, rgb_range: float, rgb_mean: Sequence[float],
                 rgb_std: Sequence[float], sign: int = -1):
        super().__init__(3, 3, 1)
        self.rgb_range = rgb_range
        self.rgb_mean = tuple(rgb_mean)
        self.rgb_std = tuple(rgb_std)
        self.sign = sign
        self.seeded_init(None)

    def seeded_init(self, generator) -> None:
        std = np.asarray(self.rgb_std, np.float32)
        with torch.no_grad():
            self.weight.copy_(torch.from_numpy(
                (np.eye(3, dtype=np.float32) / std[:, None])
                .reshape(3, 3, 1, 1)))
            self.bias.copy_(torch.from_numpy(
                self.sign * self.rgb_range
                * np.asarray(self.rgb_mean, np.float32) / std))

    def forward(self, x):
        return conv_nhwc(self, x)


class EResidualBlockNoBN(nn.Module):
    """conv, ReLU, conv, ReLU, 1 x 1 conv, then ReLU(out + x) (ref:
    ridnet_arch.py:31-52)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.body = nn.Sequential(conv(in_channels, out_channels), nn.ReLU(),
                                  conv(out_channels, out_channels), nn.ReLU(),
                                  conv(out_channels, out_channels, 1))

    def forward(self, x):
        y = F.relu(conv_nhwc(self.body[0], x))
        y = F.relu(conv_nhwc(self.body[2], y))
        return F.relu(conv_nhwc(self.body[4], y) + x)


class MergeRun(nn.Module):
    """The dual-dilation merge-and-run unit (ref: ridnet_arch.py:55-84)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.dilation1 = nn.Sequential(conv(in_channels, out_channels),
                                       nn.ReLU(),
                                       conv(out_channels, out_channels,
                                            dilation=2), nn.ReLU())
        self.dilation2 = nn.Sequential(conv(in_channels, out_channels,
                                            dilation=3), nn.ReLU(),
                                       conv(out_channels, out_channels,
                                            dilation=4), nn.ReLU())
        self.aggregation = nn.Sequential(conv(out_channels * 2,
                                              out_channels), nn.ReLU())

    def forward(self, x):
        d1 = F.relu(conv_nhwc(self.dilation1[2], F.relu(
            conv_nhwc(self.dilation1[0], x))))
        d2 = F.relu(conv_nhwc(self.dilation2[2], F.relu(
            conv_nhwc(self.dilation2[0], x))))
        out = F.relu(conv_nhwc(self.aggregation[0],
                               torch.cat([d1, d2], dim=-1)))
        return out + x


class ChannelAttention(nn.Module):
    """Global average pool, 1 x 1 squeeze, ReLU, 1 x 1 expand, sigmoid gate
    (ref: ridnet_arch.py:87-103)."""

    def __init__(self, mid_channels: int, squeeze_factor: int = 16):
        super().__init__()
        self.attention = nn.Sequential(
            nn.AdaptiveAvgPool2d(1),
            nn.Conv2d(mid_channels, mid_channels // squeeze_factor, 1),
            nn.ReLU(),
            nn.Conv2d(mid_channels // squeeze_factor, mid_channels, 1),
            nn.Sigmoid())

    def forward(self, x):
        y = x.mean(dim=(1, 2), keepdim=True)
        y = F.relu(conv_nhwc(self.attention[1], y))
        return x * torch.sigmoid(conv_nhwc(self.attention[3], y))


class EAM(nn.Module):
    """The enhancement attention module (ref: ridnet_arch.py:106-134)."""

    def __init__(self, in_channels: int, mid_channels: int,
                 out_channels: int):
        super().__init__()
        self.merge = MergeRun(in_channels, mid_channels)
        self.block1 = ResidualBlockNoBN(mid_channels)
        self.block2 = EResidualBlockNoBN(mid_channels, out_channels)
        self.ca = ChannelAttention(out_channels)

    def forward(self, x):
        out = F.relu(self.block1(self.merge(x)))
        return self.ca(self.block2(out))


@ARCH_REGISTRY.register()
class RIDNet(nn.Module):
    """The RIDNet denoiser (ref: ridnet_arch.py:137-180): (B, H, W, C) ->
    the same shape."""

    def __init__(self, in_channels: int, mid_channels: int,
                 out_channels: int, num_block: int = 4,
                 img_range: float = 255.0,
                 rgb_mean: Sequence[float] = (0.4488, 0.4371, 0.4040),
                 rgb_std: Sequence[float] = (1.0, 1.0, 1.0)):
        super().__init__()
        self.sub_mean = MeanShift(img_range, rgb_mean, rgb_std)
        self.add_mean = MeanShift(img_range, rgb_mean, rgb_std, 1)
        self.head = conv(in_channels, mid_channels)
        self.body = nn.Sequential(*(EAM(mid_channels, mid_channels,
                                        mid_channels)
                                    for _ in range(num_block)))
        self.tail = conv(mid_channels, out_channels)

    def forward(self, x):
        res = F.relu(conv_nhwc(self.head, self.sub_mean(x)))
        res = self.add_mean(conv_nhwc(self.tail, self.body(res)))
        return x + res
