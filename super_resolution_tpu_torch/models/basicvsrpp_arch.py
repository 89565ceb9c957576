"""BasicVSR++, second-order grid propagation with flow-guided deformable
alignment, NHWC (port of super_resolution_tpu/models/basicvsrpp_arch.py;
ref: basicsr/archs/basicvsrpp_arch.py:14-418).

Four propagation branches (backward_1, forward_1, backward_2, forward_2)
over a shared spatial feature; each aligns its first- and second-order
neighbours with a DCNv2 whose offsets are bounded residues around the
optical flow. The reconstruction runs once over the (B * T) batch.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from super_resolution_tpu_torch.models.arch_util import conv_nhwc
from super_resolution_tpu_torch.models.basicvsr_arch import (
    ConvResidualBlocks, UpsampleHead)
from super_resolution_tpu_torch.models.edvr_arch import conv3, lrelu
from super_resolution_tpu_torch.models.spynet_arch import SpyNet
from super_resolution_tpu_torch.ops.deform_conv import modulated_deform_conv2d
from super_resolution_tpu_torch.ops.flow import flow_warp
from super_resolution_tpu_torch.ops.resize import resize_to
from super_resolution_tpu_torch.utils.registry import ARCH_REGISTRY

BRANCHES = ("backward_1", "forward_1", "backward_2", "forward_2")


class SecondOrderDeformableAlignment(nn.Module):
    """Flow-guided second-order deformable alignment (ref:
    basicvsrpp_arch.py:347-408). ``weight`` is the raw OIHW filter;
    ``conv_offset.6`` starts at 0, as in the reference."""

    def __init__(self, in_channels: int, out_channels: int,
                 deformable_groups: int = 16,
                 max_residue_magnitude: float = 10.0):
        super().__init__()
        self.deformable_groups = deformable_groups
        self.max_residue_magnitude = max_residue_magnitude
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               3, 3))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.conv_offset = nn.Sequential(
            conv3(3 * out_channels + 4, out_channels), nn.LeakyReLU(0.1),
            conv3(out_channels, out_channels), nn.LeakyReLU(0.1),
            conv3(out_channels, out_channels), nn.LeakyReLU(0.1),
            conv3(out_channels, 27 * deformable_groups))

    def seeded_init(self, generator: torch.Generator) -> None:
        stdv = 1.0 / math.sqrt(self.weight[0].numel())
        with torch.no_grad():
            self.weight.uniform_(-stdv, stdv, generator=generator)
            self.bias.zero_()
            self.conv_offset[6].weight.zero_()
            self.conv_offset[6].bias.zero_()

    def forward(self, x, extra_feat, flow_1, flow_2):
        out = torch.cat([extra_feat, flow_1, flow_2], dim=-1)
        for i in (0, 2, 4):
            out = lrelu(conv_nhwc(self.conv_offset[i], out))
        o1, o2, mask = torch.chunk(conv_nhwc(self.conv_offset[6], out), 3,
                                   dim=-1)
        offset = self.max_residue_magnitude * torch.tanh(
            torch.cat([o1, o2], dim=-1))
        offset_1, offset_2 = torch.chunk(offset, 2, dim=-1)
        # flows are (dx, dy); the DCN's offsets (dy, dx) a tap
        reps = offset_1.shape[-1] // 2
        offset = torch.cat([offset_1 + flow_1.flip(-1).repeat(1, 1, 1, reps),
                            offset_2 + flow_2.flip(-1).repeat(1, 1, 1, reps)],
                           dim=-1)
        return modulated_deform_conv2d(
            x, offset, torch.sigmoid(mask), self.weight, self.bias,
            padding=1, deformable_groups=self.deformable_groups)


@ARCH_REGISTRY.register()
class BasicVSRPlusPlus(UpsampleHead):
    """BasicVSR++ (ref: basicvsrpp_arch.py:14-344): (B, T, H, W, 3) -> (B,
    T, 4H, 4W, 3). ``is_mirror_extended`` takes the place of the
    reference's check of the clip at run time (JAX's choice); callers that
    mirror-extend a clip set it. ``cpu_cache_length`` is accepted and
    unused, as in JAX."""

    def __init__(self, mid_channels: int = 64, num_blocks: int = 7,
                 max_residue_magnitude: float = 10.0,
                 is_low_res_input: bool = True,
                 spynet_path: str | None = None,
                 cpu_cache_length: int = 100,
                 is_mirror_extended: bool = False):
        super().__init__()
        mid = mid_channels
        self.mid_channels = mid
        self.is_low_res_input = is_low_res_input
        self.is_mirror_extended = is_mirror_extended
        self.spynet = SpyNet()
        if is_low_res_input:
            self.feat_extract = ConvResidualBlocks(3, mid, 5)
        else:
            self.feat_extract = nn.Sequential(
                nn.Conv2d(3, mid, 3, 2, 1), nn.LeakyReLU(0.1),
                nn.Conv2d(mid, mid, 3, 2, 1), nn.LeakyReLU(0.1),
                ConvResidualBlocks(mid, mid, 5))
        self.deform_align = nn.ModuleDict()
        self.backbone = nn.ModuleDict()
        for i, name in enumerate(BRANCHES):
            self.deform_align[name] = SecondOrderDeformableAlignment(
                2 * mid, mid, 16, max_residue_magnitude)
            self.backbone[name] = ConvResidualBlocks((2 + i) * mid, mid,
                                                     num_blocks)
        self.reconstruction = ConvResidualBlocks(5 * mid, mid, 5)
        self.make_head(mid)

    def compute_flow(self, lqs):
        b, t, h, w, c = lqs.shape
        l1 = lqs[:, :-1].reshape(-1, h, w, c)
        l2 = lqs[:, 1:].reshape(-1, h, w, c)
        flows_backward = self.spynet(l1, l2).reshape(b, t - 1, h, w, 2)
        if self.is_mirror_extended:
            flows_forward = flows_backward.flip(1)
        else:
            flows_forward = self.spynet(l2, l1).reshape(b, t - 1, h, w, 2)
        return flows_forward, flows_backward

    def propagate(self, feats: dict, flows, name: str) -> None:
        t = flows.shape[1] + 1
        frame_idx = list(range(t))
        flow_idx = list(range(-1, t - 1))
        if "backward" in name:
            frame_idx = frame_idx[::-1]
            flow_idx = frame_idx
        n, h, w = flows.shape[0], flows.shape[2], flows.shape[3]
        feat_prop = flows.new_zeros(n, h, w, self.mid_channels)
        branch = []
        for i, idx in enumerate(frame_idx):
            feat_current = feats["spatial"][idx]
            if i > 0:
                flow_n1 = flows[:, flow_idx[i]]
                cond_n1 = flow_warp(feat_prop, flow_n1)
                feat_n2 = torch.zeros_like(feat_prop)
                flow_n2 = torch.zeros_like(flow_n1)
                cond_n2 = torch.zeros_like(cond_n1)
                if i > 1:
                    feat_n2 = branch[-2]
                    flow_n2 = flows[:, flow_idx[i - 1]]
                    flow_n2 = flow_n1 + flow_warp(flow_n2, flow_n1)
                    cond_n2 = flow_warp(feat_n2, flow_n2)
                cond = torch.cat([cond_n1, feat_current, cond_n2], dim=-1)
                feat_prop = torch.cat([feat_prop, feat_n2], dim=-1)
                feat_prop = self.deform_align[name](feat_prop, cond, flow_n1,
                                                    flow_n2)
            feat = torch.cat([feat_current]
                             + [feats[k][idx] for k in feats
                                if k not in ("spatial", name)]
                             + [feat_prop], dim=-1)
            feat_prop = feat_prop + self.backbone[name](feat)
            branch.append(feat_prop)
        if "backward" in name:
            branch = branch[::-1]
        feats[name] = branch

    def forward(self, lqs):
        b, t, h, w, c = lqs.shape
        flat = lqs.reshape(-1, h, w, c)
        if self.is_low_res_input:
            lqs_down = lqs
            feats_flat = self.feat_extract(flat)
        else:
            lqs_down = resize_to(flat, h // 4, w // 4, "bicubic").reshape(
                b, t, h // 4, w // 4, c)
            fe = self.feat_extract
            feats_flat = fe[4](lrelu(conv_nhwc(fe[2], lrelu(
                conv_nhwc(fe[0], flat)))))
        fh, fw = feats_flat.shape[1], feats_flat.shape[2]
        spatial = feats_flat.reshape(b, t, fh, fw, -1)
        feats = {"spatial": [spatial[:, i] for i in range(t)]}
        flows_forward, flows_backward = self.compute_flow(lqs_down)
        for name in BRANCHES:
            feats[name] = []
            self.propagate(feats, flows_backward if "backward" in name
                           else flows_forward, name)
        hr = torch.stack(
            [torch.cat([feats[k][i] for k in feats], dim=-1)
             for i in range(t)], dim=1).reshape(b * t, fh, fw, -1)
        hr = self.reconstruction(hr)
        hr = (self.upsample(hr, flat) if self.is_low_res_input
              else self.head(hr) + flat)
        return hr.reshape((b, t) + hr.shape[1:])
