"""The classic CNN SR networks, NHWC (port of
super_resolution_tpu/models/cnn_archs.py): EDSR (ref:
basicsr/archs/edsr_arch.py), MSRResNet (srresnet_arch.py), RCAN
(rcan_arch.py), RRDBNet / ESRGAN (rrdbnet_arch.py), SRVGGNetCompact
(hat/archs/srvgg_arch.py) and their shared ResidualBlockNoBN
(arch_util.py:64).

Module and parameter names follow the torch checkpoints (``body.0.conv1``,
``upsample.0``, ``body.0.residual_group.1.rcab.3.attention.1``,
``body.0.rdb1.conv1``, ``body.1.weight`` of a PReLU), so an official
state_dict loads with ``strict=True``. Convolutions run in cuDNN, as in JAX:
no Pallas kernel lies on these networks.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from super_resolution_tpu_torch.models.arch_util import (conv_nhwc,
                                                         upsample_steps)
from super_resolution_tpu_torch.models.hat_classic_arch import \
    ChannelAttention
from super_resolution_tpu_torch.ops.pixelshuffle import (pixel_shuffle,
                                                         pixel_unshuffle)
from super_resolution_tpu_torch.ops.resize import resize_to
from super_resolution_tpu_torch.utils.registry import ARCH_REGISTRY


def _conv3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, 1, 1)


def _mean_shift(x, rgb_mean, img_range: float, forward: bool):
    mean = torch.tensor(rgb_mean, dtype=x.dtype, device=x.device)
    return (x - mean) * img_range if forward else x / img_range + mean


def _upx2_nearest(x):
    return x.repeat_interleave(2, 1).repeat_interleave(2, 2)


class ResidualBlockNoBN(nn.Module):
    """x + res_scale * conv2(relu(conv1(x))), 3 x 3 convs (ref:
    basicsr/archs/arch_util.py:64)."""

    def __init__(self, num_feat: int = 64, res_scale: float = 1.0):
        super().__init__()
        self.res_scale = res_scale
        self.conv1 = _conv3(num_feat, num_feat)
        self.conv2 = _conv3(num_feat, num_feat)

    def forward(self, x):
        return x + conv_nhwc(self.conv2, F.relu(conv_nhwc(self.conv1, x))) \
            * self.res_scale


class Upsample(nn.Sequential):
    """[conv(C -> r^2 C), pixel shuffle(r)] per step (x 2^n or x3), under
    the checkpoints' Sequential indices."""

    def __init__(self, scale: int, num_feat: int):
        layers = []
        for r in upsample_steps(scale):
            layers += [_conv3(num_feat, r * r * num_feat), nn.PixelShuffle(r)]
        super().__init__(*layers)

    def forward(self, x):
        for i in range(0, len(self), 2):
            x = pixel_shuffle(conv_nhwc(self[i], x), self[i + 1].upscale_factor)
        return x


class _MeanShifted(nn.Module):
    """conv_first -> body -> conv_after_body + skip -> upsample ->
    conv_last, between the DIV2K mean shifts: EDSR's and RCAN's frame."""

    def _frame(self, x, rgb_mean, img_range):
        x = _mean_shift(x, rgb_mean, img_range, True)
        feat = conv_nhwc(self.conv_first, x)
        res = feat
        for blk in self.body:
            res = blk(res)
        res = conv_nhwc(self.conv_after_body, res) + feat
        out = conv_nhwc(self.conv_last, self.upsample(res))
        return _mean_shift(out, rgb_mean, img_range, False)


@ARCH_REGISTRY.register()
class EDSR(_MeanShifted):
    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3,
                 num_feat: int = 64, num_block: int = 16, upscale: int = 4,
                 res_scale: float = 1.0, img_range: float = 255.0,
                 rgb_mean: Sequence[float] = (0.4488, 0.4371, 0.4040)):
        super().__init__()
        self.img_range, self.rgb_mean = img_range, tuple(rgb_mean)
        self.conv_first = _conv3(num_in_ch, num_feat)
        self.body = nn.ModuleList([ResidualBlockNoBN(num_feat, res_scale)
                                   for _ in range(num_block)])
        self.conv_after_body = _conv3(num_feat, num_feat)
        self.upsample = Upsample(upscale, num_feat)
        self.conv_last = _conv3(num_feat, num_out_ch)

    def forward(self, x):
        return self._frame(x, self.rgb_mean, self.img_range)


@ARCH_REGISTRY.register()
class MSRResNet(nn.Module):
    """Modified SRResNet (ref: srresnet_arch.py:9-80): residual blocks
    without BN, pixel-shuffle steps, plus the bilinear upscaled input."""

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3,
                 num_feat: int = 64, num_block: int = 16, upscale: int = 4):
        super().__init__()
        if upscale not in (2, 3, 4):
            raise ValueError(f"upscale {upscale}")
        self.upscale = upscale
        self.conv_first = _conv3(num_in_ch, num_feat)
        self.body = nn.ModuleList([ResidualBlockNoBN(num_feat)
                                   for _ in range(num_block)])
        if upscale == 4:
            self.upconv1 = _conv3(num_feat, num_feat * 4)
            self.upconv2 = _conv3(num_feat, num_feat * 4)
        else:
            self.upconv1 = _conv3(num_feat, num_feat * upscale ** 2)
        self.conv_hr = _conv3(num_feat, num_feat)
        self.conv_last = _conv3(num_feat, num_out_ch)

    def forward(self, x):
        out = F.leaky_relu(conv_nhwc(self.conv_first, x), 0.1)
        for blk in self.body:
            out = blk(out)
        ups = ([(self.upconv1, 2), (self.upconv2, 2)] if self.upscale == 4
               else [(self.upconv1, self.upscale)])
        for conv, r in ups:
            out = F.leaky_relu(pixel_shuffle(conv_nhwc(conv, out), r), 0.1)
        out = conv_nhwc(self.conv_last,
                        F.leaky_relu(conv_nhwc(self.conv_hr, out), 0.1))
        return out + resize_to(x, x.shape[1] * self.upscale,
                               x.shape[2] * self.upscale, "bilinear")


class RCAB(nn.Module):
    """Residual channel-attention block: conv -> ReLU -> conv -> channel
    attention, scaled, + x (``rcab.{0,2,3}``)."""

    def __init__(self, num_feat: int, squeeze_factor: int = 16,
                 res_scale: float = 1.0):
        super().__init__()
        self.res_scale = res_scale
        self.rcab = nn.Sequential(
            _conv3(num_feat, num_feat), nn.ReLU(True),
            _conv3(num_feat, num_feat),
            ChannelAttention(num_feat, squeeze_factor))

    def forward(self, x):
        res = conv_nhwc(self.rcab[2], F.relu(conv_nhwc(self.rcab[0], x)))
        return x + self.rcab[3](res) * self.res_scale


class RCANResidualGroup(nn.Module):
    def __init__(self, num_feat: int, num_block: int,
                 squeeze_factor: int = 16, res_scale: float = 1.0):
        super().__init__()
        self.residual_group = nn.ModuleList([
            RCAB(num_feat, squeeze_factor, res_scale)
            for _ in range(num_block)])
        self.conv = _conv3(num_feat, num_feat)

    def forward(self, x):
        res = x
        for blk in self.residual_group:
            res = blk(res)
        return x + conv_nhwc(self.conv, res)


@ARCH_REGISTRY.register()
class RCAN(_MeanShifted):
    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3,
                 num_feat: int = 64, num_group: int = 10,
                 num_block: int = 16, squeeze_factor: int = 16,
                 upscale: int = 4, res_scale: float = 1.0,
                 img_range: float = 255.0,
                 rgb_mean: Sequence[float] = (0.4488, 0.4371, 0.4040)):
        super().__init__()
        self.img_range, self.rgb_mean = img_range, tuple(rgb_mean)
        self.conv_first = _conv3(num_in_ch, num_feat)
        self.body = nn.ModuleList([
            RCANResidualGroup(num_feat, num_block, squeeze_factor, res_scale)
            for _ in range(num_group)])
        self.conv_after_body = _conv3(num_feat, num_feat)
        self.upsample = Upsample(upscale, num_feat)
        self.conv_last = _conv3(num_feat, num_out_ch)

    def forward(self, x):
        return self._frame(x, self.rgb_mean, self.img_range)


class ResidualDenseBlock(nn.Module):
    """Five 3 x 3 convs, each on the concat of the input and the earlier
    outputs, LeakyReLU(0.2) between; x + 0.2 * the last."""

    def __init__(self, num_feat: int = 64, num_grow_ch: int = 32):
        super().__init__()
        g = num_grow_ch
        self.conv1 = _conv3(num_feat, g)
        self.conv2 = _conv3(num_feat + g, g)
        self.conv3 = _conv3(num_feat + 2 * g, g)
        self.conv4 = _conv3(num_feat + 3 * g, g)
        self.conv5 = _conv3(num_feat + 4 * g, num_feat)

    def forward(self, x):
        feats = [x]
        for conv in (self.conv1, self.conv2, self.conv3, self.conv4):
            feats.append(F.leaky_relu(conv_nhwc(conv, torch.cat(feats, -1)),
                                      0.2))
        return conv_nhwc(self.conv5, torch.cat(feats, -1)) * 0.2 + x


class RRDB(nn.Module):
    """Three residual dense blocks; x + 0.2 * their output."""

    def __init__(self, num_feat: int, num_grow_ch: int = 32):
        super().__init__()
        self.rdb1 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb2 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb3 = ResidualDenseBlock(num_feat, num_grow_ch)

    def forward(self, x):
        return self.rdb3(self.rdb2(self.rdb1(x))) * 0.2 + x


@ARCH_REGISTRY.register()
class RRDBNet(nn.Module):
    """ESRGAN's generator (ref: rrdbnet_arch.py:67-125): x1 and x2 enter
    through a pixel unshuffle, then the RRDBs and two nearest x2 steps."""

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3,
                 scale: int = 4, num_feat: int = 64, num_block: int = 23,
                 num_grow_ch: int = 32):
        super().__init__()
        self.scale = scale
        stem = {2: 4, 1: 16}.get(scale, 1)
        self.conv_first = _conv3(num_in_ch * stem, num_feat)
        self.body = nn.ModuleList([RRDB(num_feat, num_grow_ch)
                                   for _ in range(num_block)])
        self.conv_body = _conv3(num_feat, num_feat)
        self.conv_up1 = _conv3(num_feat, num_feat)
        self.conv_up2 = _conv3(num_feat, num_feat)
        self.conv_hr = _conv3(num_feat, num_feat)
        self.conv_last = _conv3(num_feat, num_out_ch)

    def forward(self, x):
        if self.scale == 2:
            x = pixel_unshuffle(x, 2)
        elif self.scale == 1:
            x = pixel_unshuffle(x, 4)
        feat = conv_nhwc(self.conv_first, x)
        body = feat
        for blk in self.body:
            body = blk(body)
        feat = feat + conv_nhwc(self.conv_body, body)
        for conv in (self.conv_up1, self.conv_up2):
            feat = F.leaky_relu(conv_nhwc(conv, _upx2_nearest(feat)), 0.2)
        return conv_nhwc(self.conv_last,
                         F.leaky_relu(conv_nhwc(self.conv_hr, feat), 0.2))


@ARCH_REGISTRY.register()
class SRVGGNetCompact(nn.Module):
    """Compact VGG-style SR net (ref: hat/archs/srvgg_arch.py:7-99): convs
    and activations in ``body``, a pixel shuffle, plus the nearest upscaled
    input. ``act_type``: ``prelu``, ``relu`` or ``leakyrelu`` (0.1)."""

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3,
                 num_feat: int = 64, num_conv: int = 16, upscale: int = 4,
                 act_type: str = "prelu"):
        super().__init__()
        acts = {"prelu": lambda: nn.PReLU(num_parameters=num_feat),
                "relu": lambda: nn.ReLU(True),
                "leakyrelu": lambda: nn.LeakyReLU(0.1, True)}
        if act_type not in acts:
            raise ValueError(f"act {act_type}")
        self.upscale = upscale
        body = [_conv3(num_in_ch, num_feat), acts[act_type]()]
        for _ in range(num_conv):
            body += [_conv3(num_feat, num_feat), acts[act_type]()]
        body.append(_conv3(num_feat, num_out_ch * upscale ** 2))
        self.body = nn.ModuleList(body)

    def forward(self, x):
        out = x
        for layer in self.body:
            if isinstance(layer, nn.Conv2d):
                out = conv_nhwc(layer, out)
            elif isinstance(layer, nn.PReLU):
                out = torch.where(out >= 0, out, layer.weight * out)
            elif isinstance(layer, nn.ReLU):
                out = F.relu(out)
            else:
                out = F.leaky_relu(out, 0.1)
        s = self.upscale
        base = x.repeat_interleave(s, 1).repeat_interleave(s, 2)
        return pixel_shuffle(out, s) + base
