"""EDVR, video restoration with enhanced deformable convolutions, NHWC
(port of super_resolution_tpu/models/edvr_arch.py; ref: basicsr/archs/
edvr_arch.py:9-382).

Per-frame feature pyramids, PCD (pyramid, cascading, deformable) alignment
of every frame onto the centre one through the plain-PyTorch DCNv2
(``ops/deform_conv.py``), TSA (temporal and spatial attention) fusion, the
residual reconstruction and a x4 sub-pixel upsampler. Frames are (B, T, H,
W, C). The module names are BasicSR's (``pcd_align.offset_conv1.l1``,
``pcd_align.dcn_pack.l1``, ``fusion.temporal_attn1``), so its checkpoints
load strict.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from super_resolution_tpu_torch.models.arch_util import conv_nhwc
from super_resolution_tpu_torch.models.cnn_archs import ResidualBlockNoBN
from super_resolution_tpu_torch.ops.deform_conv import (
    dcn_offset_mask_from_conv, modulated_deform_conv2d)
from super_resolution_tpu_torch.ops.pixelshuffle import pixel_shuffle
from super_resolution_tpu_torch.ops.pool import avg_pool2d
from super_resolution_tpu_torch.ops.resize import resize_to
from super_resolution_tpu_torch.utils.registry import ARCH_REGISTRY

LEVELS = ("l3", "l2", "l1")


def conv3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride, 1)


def lrelu(x):
    return F.leaky_relu(x, 0.1)


def up2(x):
    """x2 bilinear, align_corners false (nn.Upsample of the reference)."""
    return resize_to(x, x.shape[1] * 2, x.shape[2] * 2, "bilinear")


def max_pool_3x3s2(x):
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)


def avg_pool_3x3s2(x):
    """nn.AvgPool2d(3, 2, 1): the padding counts, every window / 9."""
    return avg_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)


def residual_blocks(num_feat: int, n: int) -> nn.Sequential:
    return nn.Sequential(*(ResidualBlockNoBN(num_feat) for _ in range(n)))


class DCNv2Pack(nn.Module):
    """The alignment DCN: offsets and masks from a separate feature (ref:
    basicsr/archs/arch_util.py:205-231). ``weight`` is the raw OIHW filter
    of the reference's ModulatedDeformConvPack; ``conv_offset`` starts at 0
    (the reference's init), so the DCN starts as a plain convolution."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, padding: int = 1,
                 deformable_groups: int = 8):
        super().__init__()
        k = kernel_size
        self.padding = padding
        self.deformable_groups = deformable_groups
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               k, k))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.conv_offset = nn.Conv2d(in_channels, deformable_groups * 3 * k
                                     * k, k, 1, padding)

    def seeded_init(self, generator: torch.Generator) -> None:
        stdv = 1.0 / math.sqrt(self.weight[0].numel())
        with torch.no_grad():
            self.weight.uniform_(-stdv, stdv, generator=generator)
            self.bias.zero_()
            self.conv_offset.weight.zero_()
            self.conv_offset.bias.zero_()

    def forward(self, x, feat):
        offset, mask = dcn_offset_mask_from_conv(
            conv_nhwc(self.conv_offset, feat), self.deformable_groups)
        return modulated_deform_conv2d(
            x, offset, mask, self.weight, self.bias, padding=self.padding,
            deformable_groups=self.deformable_groups)


class PCDAlignment(nn.Module):
    """Pyramid, cascading and deformable alignment (ref:
    edvr_arch.py:9-97)."""

    def __init__(self, num_feat: int = 64, deformable_groups: int = 8):
        super().__init__()
        nf = num_feat
        self.offset_conv1 = nn.ModuleDict()
        self.offset_conv2 = nn.ModuleDict()
        self.offset_conv3 = nn.ModuleDict()
        self.dcn_pack = nn.ModuleDict()
        self.feat_conv = nn.ModuleDict()
        for level in LEVELS:
            self.offset_conv1[level] = conv3(nf * 2, nf)
            if level == "l3":
                self.offset_conv2[level] = conv3(nf, nf)
            else:
                self.offset_conv2[level] = conv3(nf * 2, nf)
                self.offset_conv3[level] = conv3(nf, nf)
            self.dcn_pack[level] = DCNv2Pack(
                nf, nf, deformable_groups=deformable_groups)
            if level != "l3":
                self.feat_conv[level] = conv3(nf * 2, nf)
        self.cas_offset_conv1 = conv3(nf * 2, nf)
        self.cas_offset_conv2 = conv3(nf, nf)
        self.cas_dcnpack = DCNv2Pack(nf, nf,
                                     deformable_groups=deformable_groups)

    def forward(self, nbr_feat_l, ref_feat_l):
        up_offset = up_feat = feat = None
        for i in range(3, 0, -1):
            level = f"l{i}"
            offset = lrelu(conv_nhwc(self.offset_conv1[level], torch.cat(
                [nbr_feat_l[i - 1], ref_feat_l[i - 1]], dim=-1)))
            if i == 3:
                offset = lrelu(conv_nhwc(self.offset_conv2[level], offset))
            else:
                offset = lrelu(conv_nhwc(self.offset_conv2[level], torch.cat(
                    [offset, up_offset], dim=-1)))
                offset = lrelu(conv_nhwc(self.offset_conv3[level], offset))
            feat = self.dcn_pack[level](nbr_feat_l[i - 1], offset)
            if i < 3:
                feat = conv_nhwc(self.feat_conv[level],
                                 torch.cat([feat, up_feat], dim=-1))
            if i > 1:
                feat = lrelu(feat)
                up_offset = up2(offset) * 2
                up_feat = up2(feat)
        offset = torch.cat([feat, ref_feat_l[0]], dim=-1)
        offset = lrelu(conv_nhwc(self.cas_offset_conv2, lrelu(
            conv_nhwc(self.cas_offset_conv1, offset))))
        return lrelu(self.cas_dcnpack(feat, offset))


class TSAFusion(nn.Module):
    """Temporal and spatial attention fusion (ref: edvr_arch.py:100-189):
    (B, T, H, W, C) -> (B, H, W, C)."""

    def __init__(self, num_feat: int = 64, num_frame: int = 5,
                 center_frame_idx: int = 2):
        super().__init__()
        nf = num_feat
        self.center_frame_idx = center_frame_idx
        self.temporal_attn1 = conv3(nf, nf)
        self.temporal_attn2 = conv3(nf, nf)
        self.feat_fusion = nn.Conv2d(num_frame * nf, nf, 1)
        self.spatial_attn1 = nn.Conv2d(num_frame * nf, nf, 1)
        self.spatial_attn2 = nn.Conv2d(nf * 2, nf, 1)
        self.spatial_attn3 = conv3(nf, nf)
        self.spatial_attn4 = nn.Conv2d(nf, nf, 1)
        self.spatial_attn5 = conv3(nf, nf)
        self.spatial_attn_l1 = nn.Conv2d(nf, nf, 1)
        self.spatial_attn_l2 = conv3(nf * 2, nf)
        self.spatial_attn_l3 = conv3(nf, nf)
        self.spatial_attn_add1 = nn.Conv2d(nf, nf, 1)
        self.spatial_attn_add2 = nn.Conv2d(nf, nf, 1)

    def forward(self, aligned_feat):
        b, t, h, w, c = aligned_feat.shape
        emb_ref = conv_nhwc(self.temporal_attn1,
                            aligned_feat[:, self.center_frame_idx])
        emb = conv_nhwc(self.temporal_attn2,
                        aligned_feat.reshape(b * t, h, w, c)).reshape(
            b, t, h, w, -1)
        corr_prob = torch.sigmoid((emb * emb_ref[:, None]).sum(-1))[..., None]
        feat = (aligned_feat * corr_prob).permute(0, 2, 3, 1, 4).reshape(
            b, h, w, t * c)
        fused = lrelu(conv_nhwc(self.feat_fusion, feat))

        attn = lrelu(conv_nhwc(self.spatial_attn1, feat))
        attn = lrelu(conv_nhwc(self.spatial_attn2, torch.cat(
            [max_pool_3x3s2(attn), avg_pool_3x3s2(attn)], dim=-1)))
        attn_level = lrelu(conv_nhwc(self.spatial_attn_l1, attn))
        attn_level = lrelu(conv_nhwc(self.spatial_attn_l2, torch.cat(
            [max_pool_3x3s2(attn_level), avg_pool_3x3s2(attn_level)],
            dim=-1)))
        attn_level = up2(lrelu(conv_nhwc(self.spatial_attn_l3, attn_level)))
        attn = lrelu(conv_nhwc(self.spatial_attn3, attn)) + attn_level
        attn = up2(lrelu(conv_nhwc(self.spatial_attn4, attn)))
        attn = conv_nhwc(self.spatial_attn5, attn)
        attn_add = conv_nhwc(self.spatial_attn_add2, lrelu(
            conv_nhwc(self.spatial_attn_add1, attn)))
        return fused * torch.sigmoid(attn) * 2 + attn_add


class PredeblurModule(nn.Module):
    """The pre-deblur pyramid head (ref: edvr_arch.py:192-242)."""

    def __init__(self, num_in_ch: int = 3, num_feat: int = 64,
                 hr_in: bool = False):
        super().__init__()
        nf = num_feat
        self.hr_in = hr_in
        self.conv_first = conv3(num_in_ch, nf)
        if hr_in:
            self.stride_conv_hr1 = conv3(nf, nf, 2)
            self.stride_conv_hr2 = conv3(nf, nf, 2)
        self.stride_conv_l2 = conv3(nf, nf, 2)
        self.stride_conv_l3 = conv3(nf, nf, 2)
        self.resblock_l3 = ResidualBlockNoBN(nf)
        self.resblock_l2_1 = ResidualBlockNoBN(nf)
        self.resblock_l2_2 = ResidualBlockNoBN(nf)
        self.resblock_l1 = nn.ModuleList(ResidualBlockNoBN(nf)
                                         for _ in range(5))

    def forward(self, x):
        feat_l1 = lrelu(conv_nhwc(self.conv_first, x))
        if self.hr_in:
            feat_l1 = lrelu(conv_nhwc(self.stride_conv_hr1, feat_l1))
            feat_l1 = lrelu(conv_nhwc(self.stride_conv_hr2, feat_l1))
        feat_l2 = lrelu(conv_nhwc(self.stride_conv_l2, feat_l1))
        feat_l3 = lrelu(conv_nhwc(self.stride_conv_l3, feat_l2))
        feat_l3 = up2(self.resblock_l3(feat_l3))
        feat_l2 = self.resblock_l2_1(feat_l2) + feat_l3
        feat_l2 = up2(self.resblock_l2_2(feat_l2))
        for i in range(2):
            feat_l1 = self.resblock_l1[i](feat_l1)
        feat_l1 = feat_l1 + feat_l2
        for i in range(2, 5):
            feat_l1 = self.resblock_l1[i](feat_l1)
        return feat_l1


class PyramidFeatures(nn.Module):
    """The L1 / L2 / L3 feature pyramid of EDVR's front end: strided
    convolution pairs after ``feature_extraction``."""

    def pyramid(self, feat_l1):
        for blk in self.feature_extraction:
            feat_l1 = blk(feat_l1)
        feat_l2 = lrelu(conv_nhwc(self.conv_l2_2, lrelu(
            conv_nhwc(self.conv_l2_1, feat_l1))))
        feat_l3 = lrelu(conv_nhwc(self.conv_l3_2, lrelu(
            conv_nhwc(self.conv_l3_1, feat_l2))))
        return feat_l1, feat_l2, feat_l3

    def align(self, feats, b: int, t: int, center: int):
        """PCD-align every frame onto frame ``center``: (B, T, H, W, C),
        one frame at a time (the DCN's column tensor is a frame's)."""
        f = [x.reshape((b, t) + x.shape[1:]) for x in feats]
        ref = [x[:, center] for x in f]
        return torch.stack([self.pcd_align([x[:, i] for x in f], ref)
                            for i in range(t)], dim=1)

    def make_pyramid_layers(self, num_feat: int, num_extract_block: int,
                            deformable_groups: int):
        nf = num_feat
        self.feature_extraction = residual_blocks(nf, num_extract_block)
        self.conv_l2_1 = conv3(nf, nf, 2)
        self.conv_l2_2 = conv3(nf, nf)
        self.conv_l3_1 = conv3(nf, nf, 2)
        self.conv_l3_2 = conv3(nf, nf)
        self.pcd_align = PCDAlignment(nf, deformable_groups)


@ARCH_REGISTRY.register()
class EDVR(PyramidFeatures):
    """EDVR (ref: edvr_arch.py:245-382). Input (B, T, H, W, C) in [0, 1];
    output the restored centre frame (B, 4H, 4W, C), or (B, H, W, C) with
    ``hr_in``."""

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3,
                 num_feat: int = 64, num_frame: int = 5,
                 deformable_groups: int = 8, num_extract_block: int = 5,
                 num_reconstruct_block: int = 10,
                 center_frame_idx: int | None = None, hr_in: bool = False,
                 with_predeblur: bool = False, with_tsa: bool = True):
        super().__init__()
        nf = num_feat
        self.center = (num_frame // 2 if center_frame_idx is None
                       else center_frame_idx)
        self.hr_in = hr_in
        self.with_predeblur = with_predeblur
        self.with_tsa = with_tsa
        if with_predeblur:
            self.predeblur = PredeblurModule(num_in_ch, nf, hr_in)
            self.conv_1x1 = nn.Conv2d(nf, nf, 1)
        else:
            self.conv_first = conv3(num_in_ch, nf)
        self.make_pyramid_layers(nf, num_extract_block, deformable_groups)
        if with_tsa:
            self.fusion = TSAFusion(nf, num_frame, self.center)
        else:
            self.fusion = nn.Conv2d(num_frame * nf, nf, 1)
        self.reconstruction = residual_blocks(nf, num_reconstruct_block)
        self.upconv1 = conv3(nf, nf * 4)
        self.upconv2 = conv3(nf, 64 * 4)
        self.conv_hr = conv3(64, 64)
        self.conv_last = conv3(64, num_out_ch)

    def forward(self, x):
        b, t, h, w, c = x.shape
        div = 16 if self.hr_in else 4
        if h % div or w % div:
            raise ValueError(f"EDVR needs sides that are multiples of {div}, "
                             f"got {h} x {w}")
        x_center = x[:, self.center]
        flat = x.reshape(b * t, h, w, c)
        if self.with_predeblur:
            feat_l1 = conv_nhwc(self.conv_1x1, self.predeblur(flat))
            if self.hr_in:
                h, w = h // 4, w // 4
        else:
            feat_l1 = lrelu(conv_nhwc(self.conv_first, flat))
        aligned = self.align(self.pyramid(feat_l1), b, t, self.center)
        if self.with_tsa:
            feat = self.fusion(aligned)
        else:
            feat = conv_nhwc(self.fusion, aligned.permute(0, 2, 3, 1, 4)
                             .reshape(b, h, w, -1))
        out = self.reconstruction(feat)
        out = lrelu(pixel_shuffle(conv_nhwc(self.upconv1, out), 2))
        out = lrelu(pixel_shuffle(conv_nhwc(self.upconv2, out), 2))
        out = lrelu(conv_nhwc(self.conv_hr, out))
        out = conv_nhwc(self.conv_last, out)
        base = (x_center if self.hr_in
                else resize_to(x_center, h * 4, w * 4, "bilinear"))
        return out + base
