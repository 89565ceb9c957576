"""TOFlow, task-oriented flow video enhancement, NHWC (port of
super_resolution_tpu/models/tof_arch.py; ref: basicsr/archs/
tof_arch.py:9-172).

A four-level SpyNet with batch norms estimates the flow from the reference
frame to each of the seven (upsampled) LR frames; the warped frames go
through a small convolutional head. Input (B, 7, H, W, 3), output (B, H, W,
3). The batch norms use their stored statistics (the shared
``FrozenBatchNorm``); ``mean`` and ``std`` are parameters, as in JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from super_resolution_tpu_torch.models.arch_util import conv_nhwc
from super_resolution_tpu_torch.models.discriminator_arch import \
    FrozenBatchNorm
from super_resolution_tpu_torch.models.spynet_arch import (IMAGENET_MEAN,
                                                           IMAGENET_STD,
                                                           channels,
                                                           stat_parameter)
from super_resolution_tpu_torch.ops.flow import (avg_pool2, flow_warp,
                                                 resize_bilinear_ac)
from super_resolution_tpu_torch.utils.registry import ARCH_REGISTRY


class TOFBasicModule(nn.Module):
    """Four (7 x 7 conv without bias, batch norm, ReLU), then a 7 x 7 conv
    to the flow (ref: tof_arch.py:9-39)."""

    def __init__(self):
        super().__init__()
        layers = []
        for cin, cout in ((8, 32), (32, 64), (64, 32), (32, 16)):
            layers += [nn.Conv2d(cin, cout, 7, padding=3, bias=False),
                       FrozenBatchNorm(cout, channel_dim=-1), nn.ReLU()]
        layers.append(nn.Conv2d(16, 2, 7, padding=3))
        self.basic_module = nn.Sequential(*layers)

    def forward(self, x):
        for layer in self.basic_module:
            if isinstance(layer, nn.Conv2d):
                x = conv_nhwc(layer, x)
            elif isinstance(layer, nn.ReLU):
                x = F.relu(x)
            else:
                x = layer(x)
        return x


class SPyNetTOF(nn.Module):
    """The four-level SpyNet of TOFlow (ref: tof_arch.py:42-90)."""

    def __init__(self):
        super().__init__()
        self.basic_module = nn.ModuleList(TOFBasicModule() for _ in range(4))

    def forward(self, ref, supp):
        b, h, w, _ = ref.shape
        ref_l, supp_l = [ref], [supp]
        for _ in range(3):
            ref_l.insert(0, avg_pool2(ref_l[0]))
            supp_l.insert(0, avg_pool2(supp_l[0]))
        flow = ref.new_zeros(b, h // 16, w // 16, 2)
        for i in range(4):
            flow_up = resize_bilinear_ac(flow, flow.shape[1] * 2,
                                         flow.shape[2] * 2) * 2.0
            flow = flow_up + self.basic_module[i](torch.cat(
                [ref_l[i], flow_warp(supp_l[i], flow_up), flow_up], dim=-1))
        return flow


@ARCH_REGISTRY.register()
class TOFlow(nn.Module):
    """TOFlow (ref: tof_arch.py:94-172). ``adapt_official_weights`` moves
    the reference frame first, as the official weights expect."""

    def __init__(self, adapt_official_weights: bool = False):
        super().__init__()
        self.adapt_official_weights = adapt_official_weights
        self.ref_idx = 0 if adapt_official_weights else 3
        self.mean = stat_parameter(IMAGENET_MEAN)
        self.std = stat_parameter(IMAGENET_STD)
        self.spynet = SPyNetTOF()
        self.conv_1 = nn.Conv2d(3 * 7, 64, 9, padding=4)
        self.conv_2 = nn.Conv2d(64, 64, 9, padding=4)
        self.conv_3 = nn.Conv2d(64, 64, 1)
        self.conv_4 = nn.Conv2d(64, 3, 1)

    def forward(self, lrs):
        if self.adapt_official_weights:
            lrs = lrs[:, [3, 0, 1, 2, 4, 5, 6]]
        mean, std = channels(self.mean), channels(self.std)
        lrs = (lrs - mean) / std
        lr_ref = lrs[:, self.ref_idx]
        aligned = []
        for i in range(7):
            if i == self.ref_idx:
                aligned.append(lr_ref)
            else:
                lr_supp = lrs[:, i]
                flow = self.spynet(lr_ref, lr_supp)
                aligned.append(flow_warp(lr_supp, flow))
        # the reference concatenates the frames channel-first: block f * 3
        hr = torch.cat(aligned, dim=-1)
        hr = F.relu(conv_nhwc(self.conv_1, hr))
        hr = F.relu(conv_nhwc(self.conv_2, hr))
        hr = F.relu(conv_nhwc(self.conv_3, hr))
        hr = conv_nhwc(self.conv_4, hr) + lr_ref
        return hr * std + mean
