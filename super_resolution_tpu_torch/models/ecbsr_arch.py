"""ECBSR, the edge-oriented convolution block SR network, NHWC (port of
super_resolution_tpu/models/ecbsr_arch.py; ref: basicsr/archs/
ecbsr_arch.py:8-275).

Each ECB trains as five parallel branches (a 3 x 3 conv, a 1 x 1 then 3 x 3
pair, and Sobel-x, Sobel-y and Laplacian filters scaled per channel) and
folds in evaluation into one 3 x 3 conv, computed from the live parameters.
Parameters keep the reference's names and OIHW layout (``conv3x3.weight``,
``conv1x1_3x3.k0``, ``conv1x1_sbx.mask``), so its checkpoints load strict.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from super_resolution_tpu_torch.ops.conv import conv2d_nhwc
from super_resolution_tpu_torch.ops.pixelshuffle import pixel_shuffle
from super_resolution_tpu_torch.utils.registry import ARCH_REGISTRY

EDGE_MASKS = {
    "conv1x1-sobelx": [[1.0, 0.0, -1.0], [2.0, 0.0, -2.0], [1.0, 0.0, -1.0]],
    "conv1x1-sobely": [[1.0, 2.0, 1.0], [0.0, 0.0, 0.0], [-1.0, -2.0, -1.0]],
    "conv1x1-laplacian": [[0.0, 1.0, 0.0], [1.0, -4.0, 1.0],
                          [0.0, 1.0, 0.0]],
}


def _uniform(p: torch.Tensor, generator: torch.Generator) -> None:
    """JAX's draw for these raw kernels: U(-sqrt(6 / fan_in), +)."""
    bound = math.sqrt(6.0 / p[0].numel())
    p.uniform_(-bound, bound, generator=generator)


class SeqConv3x3(nn.Module):
    """One re-parameterisable branch (ref: ecbsr_arch.py:8-153)."""

    def __init__(self, seq_type: str, in_channels: int, out_channels: int,
                 depth_multiplier: float = 1.0):
        super().__init__()
        self.seq_type = seq_type
        self.out_channels = out_channels
        if seq_type == "conv1x1-conv3x3":
            mid = int(out_channels * depth_multiplier)
            self.k0 = nn.Parameter(torch.empty(mid, in_channels, 1, 1))
            self.b0 = nn.Parameter(torch.zeros(mid))
            self.k1 = nn.Parameter(torch.empty(out_channels, mid, 3, 3))
            self.b1 = nn.Parameter(torch.zeros(out_channels))
        elif seq_type in EDGE_MASKS:
            self.k0 = nn.Parameter(torch.empty(out_channels, in_channels,
                                               1, 1))
            self.b0 = nn.Parameter(torch.zeros(out_channels))
            self.scale = nn.Parameter(torch.empty(out_channels, 1, 1, 1))
            self.bias = nn.Parameter(torch.empty(out_channels))
            # fixed: a parameter for the checkpoints, never trained
            self.mask = nn.Parameter(
                torch.tensor(EDGE_MASKS[seq_type]).expand(
                    out_channels, 1, 3, 3).clone(), requires_grad=False)
        else:
            raise ValueError(seq_type)

    def seeded_init(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            _uniform(self.k0, generator)
            self.b0.zero_()
            if self.seq_type == "conv1x1-conv3x3":
                _uniform(self.k1, generator)
                self.b1.zero_()
            else:
                self.scale.normal_(generator=generator).mul_(1e-3)
                self.bias.normal_(generator=generator).mul_(1e-3)

    def forward(self, x):
        # the reference pads the 1x1 conv's output with its bias, which is
        # the 1x1 conv of an input padded with zeros
        y0 = conv2d_nhwc(F.pad(x, (0, 0, 1, 1, 1, 1)), self.k0, self.b0,
                         padding=0)
        if self.seq_type == "conv1x1-conv3x3":
            return conv2d_nhwc(y0, self.k1, self.b1, padding=0)
        return conv2d_nhwc(y0, self.mask * self.scale, self.bias, padding=0,
                           groups=self.out_channels)

    def rep_params(self):
        """The equivalent single 3 x 3 (ref: ecbsr_arch.py:131-153)."""
        if self.seq_type == "conv1x1-conv3x3":
            w = torch.einsum("omhw,mi->oihw", self.k1, self.k0[:, :, 0, 0])
            b = torch.einsum("omhw,m->o", self.k1, self.b0) + self.b1
            return w, b
        tmp = self.mask * self.scale
        w = torch.einsum("ozhw,oi->oihw", tmp, self.k0[:, :, 0, 0])
        return w, self.b0 * tmp.sum(dim=(1, 2, 3)) + self.bias


class ECB(nn.Module):
    """The edge-oriented convolution block (ref: ecbsr_arch.py:156-232)."""

    def __init__(self, in_channels: int, out_channels: int,
                 depth_multiplier: float, act_type: str = "prelu",
                 with_idt: bool = False):
        super().__init__()
        self.out_channels = out_channels
        self.act_type = act_type
        self.idt = with_idt and in_channels == out_channels
        self.conv3x3 = nn.Conv2d(in_channels, out_channels, 3, 1, 1)
        self.conv1x1_3x3 = SeqConv3x3("conv1x1-conv3x3", in_channels,
                                      out_channels, depth_multiplier)
        self.conv1x1_sbx = SeqConv3x3("conv1x1-sobelx", in_channels,
                                      out_channels)
        self.conv1x1_sby = SeqConv3x3("conv1x1-sobely", in_channels,
                                      out_channels)
        self.conv1x1_lpl = SeqConv3x3("conv1x1-laplacian", in_channels,
                                      out_channels)
        if act_type == "prelu":
            self.act = nn.PReLU(num_parameters=out_channels)
        elif act_type not in ("relu", "rrelu", "softplus", "linear"):
            raise ValueError(act_type)

    def seeded_init(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            _uniform(self.conv3x3.weight, generator)
            self.conv3x3.bias.zero_()
            if self.act_type == "prelu":
                self.act.weight.fill_(0.25)

    def activate(self, y):
        if self.act_type == "prelu":
            return torch.where(y >= 0, y, self.act.weight * y)
        if self.act_type in ("relu", "rrelu"):
            # rrelu in evaluation: slope (lower + upper) / 2 = 0, as in JAX
            return F.relu(y)
        if self.act_type == "softplus":
            return F.softplus(y)
        return y

    def rep_params(self):
        w, b = self.conv3x3.weight, self.conv3x3.bias
        for branch in (self.conv1x1_3x3, self.conv1x1_sbx, self.conv1x1_sby,
                       self.conv1x1_lpl):
            wi, bi = branch.rep_params()
            w, b = w + wi, b + bi
        if self.idt:
            eye = torch.zeros_like(w)
            idx = torch.arange(self.out_channels)
            eye[idx, idx, 1, 1] = 1.0
            w = w + eye
        return w, b

    def forward(self, x, training: bool | None = None):
        """The five branches where ``training`` (by default the module's
        mode), else the folded 3 x 3."""
        if self.training if training is None else training:
            y = conv2d_nhwc(x, self.conv3x3.weight, self.conv3x3.bias,
                            padding=1)
            y = (y + self.conv1x1_3x3(x) + self.conv1x1_sbx(x)
                 + self.conv1x1_sby(x) + self.conv1x1_lpl(x))
            if self.idt:
                y = y + x
        else:
            w, b = self.rep_params()
            y = conv2d_nhwc(x, w, b, padding=1)
        return self.activate(y)


@ARCH_REGISTRY.register()
class ECBSR(nn.Module):
    """The ECB trunk and a sub-pixel head (ref: ecbsr_arch.py:235-275)."""

    def __init__(self, num_in_ch: int, num_out_ch: int, num_block: int,
                 num_channel: int, with_idt: bool, act_type: str,
                 scale: int):
        super().__init__()
        self.num_in_ch = num_in_ch
        self.scale = scale
        blocks = [ECB(num_in_ch, num_channel, 2.0, act_type, with_idt)]
        blocks += [ECB(num_channel, num_channel, 2.0, act_type, with_idt)
                   for _ in range(num_block)]
        blocks.append(ECB(num_channel, num_out_ch * scale ** 2, 2.0,
                          "linear", with_idt))
        self.backbone = nn.Sequential(*blocks)

    def forward(self, x, training: bool | None = None):
        shortcut = (x.repeat_interleave(self.scale ** 2, dim=-1)
                    if self.num_in_ch > 1 else x)
        y = x
        for blk in self.backbone:
            y = blk(y, training=training)
        return pixel_shuffle(y + shortcut, self.scale)
