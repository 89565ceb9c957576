"""The CNN building blocks of super_resolution_tpu/models/cnn_archs.py,
NHWC; so far the one the arbitrary-scale EDSR encoder needs."""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from super_resolution_tpu_torch.models.arch_util import conv_nhwc


class ResidualBlockNoBN(nn.Module):
    """x + res_scale * conv2(relu(conv1(x))), 3 x 3 convs (ref:
    basicsr/archs/arch_util.py:64)."""

    def __init__(self, num_feat: int = 64, res_scale: float = 1.0):
        super().__init__()
        self.res_scale = res_scale
        self.conv1 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv2 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)

    def forward(self, x):
        return x + conv_nhwc(self.conv2, F.relu(conv_nhwc(self.conv1, x))) \
            * self.res_scale
