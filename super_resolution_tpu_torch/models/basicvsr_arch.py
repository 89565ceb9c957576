"""BasicVSR and IconVSR, recurrent video SR, NHWC (port of
super_resolution_tpu/models/basicvsr_arch.py; ref: basicsr/archs/
basicvsr_arch.py:11-336).

SpyNet flows between neighbouring frames, feature propagation backward
and then forward in time with the flow warp, and a x4 sub-pixel
reconstruction. As in JAX, the propagation collects every frame's features
and the reconstruction runs once over the (B * T) batch: the reference's
arithmetic, in fewer, larger convolutions. Module names are BasicSR's
(``backward_trunk.main.2.{i}``), so its checkpoints load strict.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from super_resolution_tpu_torch.models.arch_util import conv_nhwc
from super_resolution_tpu_torch.models.edvr_arch import (PyramidFeatures,
                                                         TSAFusion, conv3,
                                                         lrelu,
                                                         residual_blocks)
from super_resolution_tpu_torch.models.spynet_arch import SpyNet
from super_resolution_tpu_torch.ops.flow import flow_warp
from super_resolution_tpu_torch.ops.pixelshuffle import pixel_shuffle
from super_resolution_tpu_torch.ops.resize import resize_to
from super_resolution_tpu_torch.utils.registry import ARCH_REGISTRY


class ConvResidualBlocks(nn.Module):
    """A 3 x 3 conv, LeakyReLU(0.1), then ``num_block`` residual blocks,
    under BasicSR's ``main.0`` / ``main.2.{i}`` names (ref:
    basicvsr_arch.py:101-117)."""

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 64,
                 num_block: int = 15):
        super().__init__()
        self.main = nn.Sequential(conv3(num_in_ch, num_out_ch),
                                  nn.LeakyReLU(0.1),
                                  residual_blocks(num_out_ch, num_block))

    def forward(self, x):
        return self.main[2](lrelu(conv_nhwc(self.main[0], x)))


def pair_flows(spynet, x):
    """The flows between neighbouring frames of x (B, T, H, W, C): forward
    (frame i + 1 warped onto i's successor) and backward, each (B, T - 1,
    H, W, 2); SpyNet runs on 2 (T - 1) frame pairs."""
    b, n, h, w, c = x.shape
    x1 = x[:, :-1].reshape(-1, h, w, c)
    x2 = x[:, 1:].reshape(-1, h, w, c)
    flows_backward = spynet(x1, x2).reshape(b, n - 1, h, w, 2)
    flows_forward = spynet(x2, x1).reshape(b, n - 1, h, w, 2)
    return flows_forward, flows_backward


class UpsampleHead(nn.Module):
    """upconv1 / upconv2 with pixel shuffles, conv_hr, conv_last (``head``:
    (N, H, W, C) -> (N, 4H, 4W, 3)), plus the bilinear x4 of the LR frames
    (``upsample``)."""

    def make_head(self, num_feat: int):
        self.upconv1 = conv3(num_feat, num_feat * 4)
        self.upconv2 = conv3(num_feat, 64 * 4)
        self.conv_hr = conv3(64, 64)
        self.conv_last = conv3(64, 3)

    def head(self, out):
        out = lrelu(pixel_shuffle(conv_nhwc(self.upconv1, out), 2))
        out = lrelu(pixel_shuffle(conv_nhwc(self.upconv2, out), 2))
        out = lrelu(conv_nhwc(self.conv_hr, out))
        return conv_nhwc(self.conv_last, out)

    def upsample(self, out, lr):
        h, w = lr.shape[1], lr.shape[2]
        return self.head(out) + resize_to(lr, h * 4, w * 4, "bilinear")


@ARCH_REGISTRY.register()
class BasicVSR(UpsampleHead):
    """BasicVSR x4 (ref: basicvsr_arch.py:11-98): (B, T, H, W, 3) -> (B, T,
    4H, 4W, 3). ``spynet_path`` is the checkpoint layer's business."""

    def __init__(self, num_feat: int = 64, num_block: int = 15,
                 spynet_path: str | None = None):
        super().__init__()
        self.num_feat = num_feat
        self.spynet = SpyNet()
        self.backward_trunk = ConvResidualBlocks(num_feat + 3, num_feat,
                                                 num_block)
        self.forward_trunk = ConvResidualBlocks(num_feat + 3, num_feat,
                                                num_block)
        self.fusion = nn.Conv2d(num_feat * 2, num_feat, 1)
        self.make_head(num_feat)

    def forward(self, x):
        flows_forward, flows_backward = pair_flows(self.spynet, x)
        b, n, h, w, _ = x.shape
        out_l = [None] * n
        feat_prop = x.new_zeros(b, h, w, self.num_feat)
        for i in range(n - 1, -1, -1):
            if i < n - 1:
                feat_prop = flow_warp(feat_prop, flows_backward[:, i])
            feat_prop = self.backward_trunk(
                torch.cat([x[:, i], feat_prop], dim=-1))
            out_l[i] = feat_prop
        feats = []
        feat_prop = torch.zeros_like(feat_prop)
        for i in range(n):
            if i > 0:
                feat_prop = flow_warp(feat_prop, flows_forward[:, i - 1])
            feat_prop = self.forward_trunk(
                torch.cat([x[:, i], feat_prop], dim=-1))
            feats.append(torch.cat([out_l[i], feat_prop], dim=-1))
        out = torch.stack(feats, dim=1).reshape(b * n, h, w, -1)
        out = lrelu(conv_nhwc(self.fusion, out))
        out = self.upsample(out, x.reshape(b * n, h, w, -1))
        return out.reshape(b, n, h * 4, w * 4, -1)


class EDVRFeatureExtractor(PyramidFeatures):
    """EDVR's front end for IconVSR's keyframes (ref:
    basicvsr_arch.py:271-336): (B, T, H, W, 3) -> (B, H, W, C)."""

    def __init__(self, num_input_frame: int, num_feat: int):
        super().__init__()
        self.center = num_input_frame // 2
        self.conv_first = conv3(3, num_feat)
        self.make_pyramid_layers(num_feat, 5, 8)
        self.fusion = TSAFusion(num_feat, num_input_frame, self.center)

    def forward(self, x):
        b, n, h, w, c = x.shape
        feat_l1 = lrelu(conv_nhwc(self.conv_first, x.reshape(-1, h, w, c)))
        return self.fusion(self.align(self.pyramid(feat_l1), b, n,
                                      self.center))


@ARCH_REGISTRY.register()
class IconVSR(UpsampleHead):
    """IconVSR (ref: basicvsr_arch.py:120-268): BasicVSR with EDVR features
    fused in at keyframes every ``keyframe_stride`` frames."""

    def __init__(self, num_feat: int = 64, num_block: int = 15,
                 keyframe_stride: int = 5, temporal_padding: int = 2,
                 spynet_path: str | None = None,
                 edvr_path: str | None = None):
        super().__init__()
        self.num_feat = num_feat
        self.keyframe_stride = keyframe_stride
        self.temporal_padding = temporal_padding
        self.edvr = EDVRFeatureExtractor(temporal_padding * 2 + 1, num_feat)
        self.spynet = SpyNet()
        self.backward_fusion = conv3(2 * num_feat, num_feat)
        self.backward_trunk = ConvResidualBlocks(num_feat + 3, num_feat,
                                                 num_block)
        self.forward_fusion = conv3(2 * num_feat, num_feat)
        self.forward_trunk = ConvResidualBlocks(2 * num_feat + 3, num_feat,
                                                num_block)
        self.make_head(num_feat)

    @staticmethod
    def pad_spatial(x):
        """Reflect-pad H and W of (B, T, H, W, C) up to multiples of 4."""
        b, t, h, w, c = x.shape
        pad_h, pad_w = (4 - h % 4) % 4, (4 - w % 4) % 4
        y = F.pad(x.reshape(b * t, h, w, c).permute(0, 3, 1, 2),
                  (0, pad_w, 0, pad_h), mode="reflect")
        return y.permute(0, 2, 3, 1).reshape(b, t, h + pad_h, w + pad_w, c)

    def get_keyframe_feature(self, x, keyframe_idx):
        if self.temporal_padding == 2:
            x = torch.cat([x[:, [4, 3]], x, x[:, [-4, -5]]], dim=1)
        elif self.temporal_padding == 3:
            x = torch.cat([x[:, [6, 5, 4]], x, x[:, [-5, -6, -7]]], dim=1)
        num_frames = 2 * self.temporal_padding + 1
        return {i: self.edvr(x[:, i:i + num_frames]) for i in keyframe_idx}

    def forward(self, x):
        b, n, h_input, w_input = x.shape[:4]
        x = self.pad_spatial(x)
        h, w = x.shape[2], x.shape[3]
        keyframe_idx = list(range(0, n, self.keyframe_stride))
        if keyframe_idx[-1] != n - 1:
            keyframe_idx.append(n - 1)
        flows_forward, flows_backward = pair_flows(self.spynet, x)
        feats_keyframe = self.get_keyframe_feature(x, keyframe_idx)

        out_l = [None] * n
        feat_prop = x.new_zeros(b, h, w, self.num_feat)
        for i in range(n - 1, -1, -1):
            if i < n - 1:
                feat_prop = flow_warp(feat_prop, flows_backward[:, i])
            if i in keyframe_idx:
                feat_prop = conv_nhwc(self.backward_fusion, torch.cat(
                    [feat_prop, feats_keyframe[i]], dim=-1))
            feat_prop = self.backward_trunk(
                torch.cat([x[:, i], feat_prop], dim=-1))
            out_l[i] = feat_prop
        feats = []
        feat_prop = torch.zeros_like(feat_prop)
        for i in range(n):
            if i > 0:
                feat_prop = flow_warp(feat_prop, flows_forward[:, i - 1])
            if i in keyframe_idx:
                feat_prop = conv_nhwc(self.forward_fusion, torch.cat(
                    [feat_prop, feats_keyframe[i]], dim=-1))
            feat_prop = self.forward_trunk(
                torch.cat([x[:, i], out_l[i], feat_prop], dim=-1))
            feats.append(feat_prop)
        out = torch.stack(feats, dim=1).reshape(b * n, h, w, -1)
        out = self.upsample(out, x.reshape(b * n, h, w, -1))
        out = out.reshape(b, n, h * 4, w * 4, -1)
        return out[:, :, :4 * h_input, :4 * w_input]
