"""DFDNet, the deep face dictionary network (port of super_resolution_tpu/
models/dfdnet_arch.py; ref: basicsr/archs/dfdnet_arch.py:12-169,
dfdnet_util.py:41-162).

VGG19 features of the face (``models/vgg_arch.py``) have each facial part
(left eye, right eye, nose, mouth) replaced, at four scales, by the most
similar atom of a component dictionary, after an AdaIN of the dictionary to
the part; SFT up-blocks decode the result. The dictionary is {f_size:
{part: (N, C, h, w)}} (the reference's ``.pth``, loaded from ``dict_path``
or handed to ``forward``); the correlation of a part with every atom is one
valid conv whose filters are the atoms, then an argmax. Part boxes and the
atom picked depend on the data, so the forward runs eagerly at batch 1, as
in JAX and the reference. NHWC in and out, NCHW inside.

The VGG extractor is the port's, under torchvision's ``features.N`` names;
BasicSR's checkpoint names the same convs ``vgg_extractor.vgg_net.
convX_Y``, so loading the official file needs that rename (ROADMAP.md
queue 3).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from super_resolution_tpu_torch.models.arch_util import \
    StoredSpectralNormConv2d as SNConv
from super_resolution_tpu_torch.models.vgg_arch import VGGFeatureExtractor
from super_resolution_tpu_torch.utils.registry import ARCH_REGISTRY

_BLUR = ((1.0, 2.0, 1.0), (2.0, 4.0, 2.0), (1.0, 2.0, 1.0))


class Blur(nn.Module):
    """3 x 3 binomial depthwise blur (ref: dfdnet_util.py:41-54)."""

    def forward(self, x):
        c = x.shape[1]
        k = torch.tensor(_BLUR, dtype=x.dtype, device=x.device) / 16.0
        return F.conv2d(x, k.expand(c, 1, 3, 3), padding=1, groups=c)


def calc_mean_std(feat, eps: float = 1e-5):
    """Per-channel mean and std over H, W with the UNBIASED variance, as
    the reference (ref: dfdnet_util.py:57-71)."""
    n, c = feat.shape[:2]
    flat = feat.reshape(n, c, -1)
    var = flat.var(dim=2, unbiased=flat.shape[2] > 1) + eps
    return (flat.mean(dim=2).reshape(n, c, 1, 1),
            var.sqrt().reshape(n, c, 1, 1))


def adaptive_instance_normalization(content_feat, style_feat):
    """(ref: dfdnet_util.py:74-88)."""
    style_mean, style_std = calc_mean_std(style_feat)
    content_mean, content_std = calc_mean_std(content_feat)
    return ((content_feat - content_mean) / content_std * style_std
            + style_mean)


def _bilinear(x, out_h: int, out_w: int):
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=False)


def attention_block(channels: int) -> nn.Sequential:
    """SN conv -> leaky ReLU -> SN conv (ref: dfdnet_util.py:91-94)."""
    return nn.Sequential(SNConv(channels, channels, 3, padding=1),
                         nn.LeakyReLU(0.2),
                         SNConv(channels, channels, 3, padding=1))


class MSDilationBlock(nn.Module):
    """Four dilated SN conv pairs, fused, plus the input (ref:
    dfdnet_util.py:123-147)."""

    def __init__(self, in_channels: int, kernel_size: int = 3,
                 dilation=(1, 1, 1, 1)):
        super().__init__()
        blocks = []
        for d in dilation:
            pad = ((kernel_size - 1) // 2) * d
            blocks.append(nn.Sequential(
                SNConv(in_channels, in_channels, kernel_size, padding=pad,
                       dilation=d),
                nn.LeakyReLU(0.2),
                SNConv(in_channels, in_channels, kernel_size, padding=pad,
                       dilation=d)))
        self.conv_blocks = nn.ModuleList(blocks)
        self.conv_fusion = SNConv(in_channels * 4, in_channels, kernel_size,
                                  padding=(kernel_size - 1) // 2)

    def forward(self, x):
        out = torch.cat([blk(x) for blk in self.conv_blocks], 1)
        return self.conv_fusion(out) + x


class UpResBlock(nn.Module):
    """(ref: dfdnet_util.py:150-162)."""

    def __init__(self, channels: int):
        super().__init__()
        self.body = nn.Sequential(nn.Conv2d(channels, channels, 3, 1, 1),
                                  nn.LeakyReLU(0.2),
                                  nn.Conv2d(channels, channels, 3, 1, 1))

    def forward(self, x):
        return x + self.body(x)


class Upsample2x(nn.Module):
    def forward(self, x):
        return _bilinear(x, x.shape[2] * 2, x.shape[3] * 2)


class SFTUpBlock(nn.Module):
    """Spatial feature transform, then x2 (ref: dfdnet_arch.py:12-53)."""

    def __init__(self, in_channel: int, out_channel: int):
        super().__init__()
        self.conv1 = nn.Sequential(
            Blur(), SNConv(in_channel, out_channel, 3, padding=1),
            nn.LeakyReLU(0.04))
        self.convup = nn.Sequential(
            Upsample2x(), SNConv(out_channel, out_channel, 3, padding=1),
            nn.LeakyReLU(0.2))
        self.scale_block = nn.Sequential(
            SNConv(in_channel, out_channel, 3, padding=1), nn.LeakyReLU(0.2),
            SNConv(out_channel, out_channel, 3, padding=1))
        self.shift_block = nn.Sequential(
            SNConv(in_channel, out_channel, 3, padding=1), nn.LeakyReLU(0.2),
            SNConv(out_channel, out_channel, 3, padding=1), nn.Sigmoid())

    def forward(self, x, updated_feat):
        out = self.conv1(x)
        out = out * self.scale_block(updated_feat) + self.shift_block(
            updated_feat)
        return self.convup(out)


@ARCH_REGISTRY.register()
class DFDNet(nn.Module):
    """DFDNet (ref: dfdnet_arch.py:56-169): 512 x 512 faces, batch 1."""

    parts = ("left_eye", "right_eye", "nose", "mouth")
    feature_sizes = (256, 128, 64, 32)
    vgg_layers = ("relu2_2", "relu3_4", "relu4_4", "conv5_4")
    channel_sizes = (128, 256, 512, 512)

    def __init__(self, num_feat: int, dict_path: str | None = None):
        super().__init__()
        self.dict = (torch.load(dict_path, map_location="cpu",
                                weights_only=True) if dict_path else None)
        self.vgg_extractor = VGGFeatureExtractor(
            layer_name_list=list(self.vgg_layers), use_input_norm=True,
            range_norm=True)
        self.attn_blocks = nn.ModuleDict({
            f"{name}_{f_size}": attention_block(self.channel_sizes[idx])
            for idx, f_size in enumerate(self.feature_sizes)
            for name in self.parts})
        self.multi_scale_dilation = MSDilationBlock(num_feat * 8,
                                                    dilation=(4, 3, 2, 1))
        self.upsample0 = SFTUpBlock(num_feat * 8, num_feat * 8)
        self.upsample1 = SFTUpBlock(num_feat * 8, num_feat * 4)
        self.upsample2 = SFTUpBlock(num_feat * 4, num_feat * 2)
        self.upsample3 = SFTUpBlock(num_feat * 2, num_feat)
        self.upsample4 = nn.Sequential(
            SNConv(num_feat, num_feat, 3, padding=1), nn.LeakyReLU(0.2),
            UpResBlock(num_feat), UpResBlock(num_feat),
            nn.Conv2d(num_feat, 3, 3, 1, 1), nn.Tanh())

    def best_atom(self, scores) -> int:
        """The atom of the highest correlation (the reference's argmax of
        the softmax)."""
        return int(torch.argmax(scores))

    def swap_feat(self, vgg_feat, updated_feat, dict_feat, location,
                  part_name: str, f_size: int):
        """Replace the part at ``location`` (x0, y0, x1, y1) by its best
        atom of ``dict_feat`` (N, C, h, w) (ref: dfdnet_arch.py:105-124)."""
        x0, y0, x1, y1 = location
        part_feat = vgg_feat[:, :, y0:y1, x0:x1]
        part_resize_feat = _bilinear(part_feat, dict_feat.shape[2],
                                     dict_feat.shape[3])
        dict_feat_n = adaptive_instance_normalization(dict_feat,
                                                      part_resize_feat)
        score = F.conv2d(part_resize_feat, dict_feat_n)   # (1, N, 1, 1)
        select_idx = self.best_atom(score.reshape(-1))
        swap = F.interpolate(dict_feat_n[select_idx:select_idx + 1],
                             size=part_feat.shape[2:], mode="nearest")
        attn = self.attn_blocks[f"{part_name}_{f_size}"](swap - part_feat)
        updated_feat = updated_feat.clone()
        updated_feat[:, :, y0:y1, x0:x1] = attn * swap + part_feat
        return updated_feat

    def forward(self, x, part_locations, dictionary=None):
        """x: (1, 512, 512, 3) in [-1, 1]; part_locations: four (b, 4)
        boxes in 512-scale pixels, one per part; dictionary: as
        ``dict_path``'s, on x's device (default: the loaded one). Returns
        (1, 512, 512, 3)."""
        dictionary = self.dict if dictionary is None else dictionary
        vgg_features = self.vgg_extractor(x)
        updated = []
        batch = 0
        for vgg_layer, f_size in zip(self.vgg_layers, self.feature_sizes):
            dict_features = dictionary[f"{f_size}"]
            vgg_feat = vgg_features[vgg_layer]
            updated_feat = vgg_feat
            for part_idx, part_name in enumerate(self.parts):
                location = [int(v) // (512 // f_size) for v in
                            part_locations[part_idx][batch]]
                updated_feat = self.swap_feat(
                    vgg_feat, updated_feat,
                    dict_features[part_name].to(x.device, x.dtype),
                    location, part_name, f_size)
            updated.append(updated_feat)

        feat = self.multi_scale_dilation(vgg_features["conv5_4"])
        feat = self.upsample0(feat, updated[3])
        feat = self.upsample1(feat, updated[2])
        feat = self.upsample2(feat, updated[1])
        feat = self.upsample3(feat, updated[0])
        return self.upsample4(feat).permute(0, 2, 3, 1)
