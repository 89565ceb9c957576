"""The FID-patched InceptionV3 feature extractor (port of
super_resolution_tpu/models/inception_arch.py; ref:
basicsr/archs/inception.py:1-310): torchvision's inception_v3 with 1008
classes and no aux logits, and the TF-parity patches (the 3 x 3 average
pools leave the padding out of the divisor; Mixed_7c's pool branch is a max
pool). No torchvision: the blocks are written out here.

Module names are the pt_inception checkpoint's (``Conv2d_1a_3x3.conv``,
``Mixed_5b.branch1x1.bn``), so :func:`load_fid_inception` loads it strict,
in its raw layout or in the reference wrapper's ``blocks.N.M.`` layout;
``fc.*`` and ``AuxLogits.*`` are passed over. BatchNorm runs on its stored
statistics (eps 1e-3) in every mode: the extractor is frozen. NHWC in; the
output blocks are NCHW.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3


class BasicConv2d(nn.Module):
    """Conv (no bias) + frozen BatchNorm + ReLU."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size,
                              stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(out_channels, eps=BN_EPS)

    def forward(self, x):
        bn = self.bn
        return F.relu(F.batch_norm(self.conv(x), bn.running_mean,
                                   bn.running_var, bn.weight, bn.bias,
                                   False, 0.0, bn.eps))


def avg_pool_valid(x):
    """3 x 3 / 1 average pool, the divisor counting the taps inside."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, in_channels: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_channels, 64, 1)
        self.branch5x5_1 = BasicConv2d(in_channels, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(in_channels, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, bd,
                          self.branch_pool(avg_pool_valid(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_channels, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, in_channels: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(in_channels, 192, 1)
        self.branch7x7_1 = BasicConv2d(in_channels, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_channels, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_channels, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(avg_pool_valid(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_channels, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_channels, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7,
                          F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    """``pool_mode`` 'avg': FIDInceptionE_1 (Mixed_7b); 'max':
    FIDInceptionE_2 (Mixed_7c)."""

    def __init__(self, in_channels: int, pool_mode: str = "avg"):
        super().__init__()
        self.pool_mode = pool_mode
        self.branch1x1 = BasicConv2d(in_channels, 320, 1)
        self.branch3x3_1 = BasicConv2d(in_channels, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_channels, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       1)
        bp = (F.max_pool2d(x, 3, 1, 1) if self.pool_mode == "max"
              else avg_pool_valid(x))
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)],
                         1)


class FIDInceptionV3(nn.Module):
    """The feature maps of ``output_blocks``, ascending (ref: inception.py
    InceptionV3.forward:123-151): 0 after the first max pool (64 ch), 1
    after the second (192), 2 before the aux head (768), 3 the global
    average pool (2048, 1 x 1). Input NHWC RGB, in [0, 1] with
    ``normalize_input``, else in [-1, 1]; ``resize_input`` resizes to 299 x
    299 (bilinear, ``align_corners=False``, no antialias)."""

    def __init__(self, output_blocks: Sequence[int] = (3,),
                 resize_input: bool = True, normalize_input: bool = True):
        super().__init__()
        self.output_blocks = sorted(output_blocks)
        if self.output_blocks[-1] > 3:
            raise ValueError("output block indices go up to 3")
        self.resize_input = resize_input
        self.normalize_input = normalize_input
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")

    def forward(self, x) -> list:
        x = x.permute(0, 3, 1, 2)
        if self.resize_input:
            x = F.interpolate(x, size=(299, 299), mode="bilinear",
                              align_corners=False)
        if self.normalize_input:
            x = 2 * x - 1
        last = self.output_blocks[-1]
        outputs = {}
        for layer in ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3"):
            x = getattr(self, layer)(x)
        outputs[0] = x = F.max_pool2d(x, 3, 2)
        if last >= 1:
            x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
            outputs[1] = x = F.max_pool2d(x, 3, 2)
        if last >= 2:
            for layer in _BLOCK_LAYOUT[2]:
                x = getattr(self, layer)(x)
            outputs[2] = x
        if last >= 3:
            for layer in ("Mixed_7a", "Mixed_7b", "Mixed_7c"):
                x = getattr(self, layer)(x)
            outputs[3] = x.mean(dim=(2, 3), keepdim=True)
        return [outputs[i] for i in self.output_blocks]


# the layers of the reference wrapper's blocks, for its 'blocks.N.M.' keys
# (None: a pooling layer), a copy of the JAX package's _BLOCK_LAYOUT
_BLOCK_LAYOUT = {
    0: ["Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3", None],
    1: ["Conv2d_3b_1x1", "Conv2d_4a_3x3", None],
    2: ["Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b",
        "Mixed_6c", "Mixed_6d", "Mixed_6e"],
    3: ["Mixed_7a", "Mixed_7b", "Mixed_7c", None],
}


def fid_inception_state_dict(state_dict: dict) -> dict:
    """A pt_inception state dict in either layout under this module's
    names: 'blocks.N.M.rest' -> '<layer>.rest'; ``fc.*``, ``AuxLogits.*``
    and the BatchNorms' batch counters dropped."""
    out = {}
    for key, value in state_dict.items():
        parts = key.split(".")
        if parts[0] == "blocks":
            layer = _BLOCK_LAYOUT[int(parts[1])][int(parts[2])]
            if layer is None:
                raise KeyError(f"{key}: a pooling layer has no weights")
            parts = [layer] + parts[3:]
        if (parts[0] in ("fc", "AuxLogits")
                or parts[-1] == "num_batches_tracked"):
            continue
        out[".".join(parts)] = value
    return out


def load_fid_inception(net: FIDInceptionV3, state_dict: dict) -> None:
    """Load a pt_inception state dict strict (:func:
    `fid_inception_state_dict`): every weight and statistic of ``net``
    must be in it and it may hold nothing else."""
    state = fid_inception_state_dict(state_dict)
    own = {k for k in net.state_dict() if not k.endswith(
        "num_batches_tracked")}
    missing, unexpected = sorted(own - set(state)), sorted(set(state) - own)
    if missing or unexpected:
        raise KeyError(f"pt_inception state dict: missing {missing[:5]}, "
                       f"unexpected {unexpected[:5]}")
    net.load_state_dict(state, strict=False)
