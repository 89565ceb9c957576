"""SpyNet optical-flow estimator, NHWC (port of super_resolution_tpu/
models/spynet_arch.py; ref: basicsr/archs/spynet_arch.py:9-96).

Six pyramid levels: each warps the support frame by the upsampled flow and
adds a residual flow. Flows are (B, H, W, 2) with channels (dx, dy). The
module names are BasicSR's (``basic_module.{i}.basic_module.{j}``), so its
checkpoints load strict; ``mean`` and ``std`` are parameters, as in JAX.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from super_resolution_tpu_torch.models.arch_util import conv_nhwc
from super_resolution_tpu_torch.ops.flow import (avg_pool2, flow_warp,
                                                 resize_bilinear_ac)
from super_resolution_tpu_torch.ops.resize import resize_to
from super_resolution_tpu_torch.utils.registry import ARCH_REGISTRY

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def stat_parameter(values) -> nn.Parameter:
    """A (1, 3, 1, 1) parameter, the layout of BasicSR's buffers."""
    return nn.Parameter(torch.tensor(values).reshape(1, 3, 1, 1))


def channels(p: torch.Tensor) -> torch.Tensor:
    """A (1, 3, 1, 1) statistic as a vector over NHWC's last axis."""
    return p.reshape(3)


class SpyNetBasicModule(nn.Module):
    """Five 7 x 7 convolutions 8 -> 32 -> 64 -> 32 -> 16 -> 2, ReLU
    between them (ref: spynet_arch.py:10-25)."""

    def __init__(self):
        super().__init__()
        layers = []
        for cin, cout in ((8, 32), (32, 64), (64, 32), (32, 16)):
            layers += [nn.Conv2d(cin, cout, 7, padding=3), nn.ReLU()]
        layers.append(nn.Conv2d(16, 2, 7, padding=3))
        self.basic_module = nn.Sequential(*layers)

    def forward(self, x):
        for layer in self.basic_module:
            x = (conv_nhwc(layer, x) if isinstance(layer, nn.Conv2d)
                 else F.relu(x))
        return x


def pad_edge_to(up, h: int, w: int):
    """Repeat the last row / column of ``up`` until it is h x w (the
    reference's replicate pad of one pixel)."""
    if up.shape[1] != h:
        up = torch.cat([up, up[:, -1:]], dim=1)
    if up.shape[2] != w:
        up = torch.cat([up, up[:, :, -1:]], dim=2)
    return up


@ARCH_REGISTRY.register()
class SpyNet(nn.Module):
    """forward(ref, supp): two (B, H, W, 3) frames in [0, 1] -> the flow
    (B, H, W, 2) that warps supp onto ref (ref: spynet_arch.py:28-96).
    ``load_path`` is the checkpoint layer's business, not the module's."""

    def __init__(self, load_path: str | None = None):
        super().__init__()
        self.basic_module = nn.ModuleList(SpyNetBasicModule()
                                          for _ in range(6))
        self.mean = stat_parameter(IMAGENET_MEAN)
        self.std = stat_parameter(IMAGENET_STD)

    def process(self, ref, supp):
        mean, std = channels(self.mean), channels(self.std)
        ref = [(ref - mean) / std]
        supp = [(supp - mean) / std]
        for _ in range(5):
            ref.insert(0, avg_pool2(ref[0]))
            supp.insert(0, avg_pool2(supp[0]))
        b, h0, w0 = ref[0].shape[:3]
        flow = ref[0].new_zeros(b, h0 // 2, w0 // 2, 2)
        for level in range(len(ref)):
            up = resize_bilinear_ac(flow, flow.shape[1] * 2,
                                    flow.shape[2] * 2) * 2.0
            up = pad_edge_to(up, ref[level].shape[1], ref[level].shape[2])
            inp = torch.cat([ref[level],
                             flow_warp(supp[level], up,
                                       padding_mode="border"), up], dim=-1)
            flow = self.basic_module[level](inp) + up
        return flow

    def forward(self, ref, supp):
        h, w = ref.shape[1], ref.shape[2]
        w_floor = math.floor(math.ceil(w / 32.0) * 32.0)
        h_floor = math.floor(math.ceil(h / 32.0) * 32.0)
        ref_r = resize_to(ref, h_floor, w_floor, "bilinear")
        supp_r = resize_to(supp, h_floor, w_floor, "bilinear")
        flow = resize_to(self.process(ref_r, supp_r), h, w, "bilinear")
        return flow * flow.new_tensor([w / w_floor, h / h_floor])
