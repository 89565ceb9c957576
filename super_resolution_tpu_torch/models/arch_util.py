"""Shared building blocks of the port's architectures, NHWC: the parts of
super_resolution_tpu/models/arch_util.py the HAT family uses, and what the
classic HAT and the fork's HAT have in common (the operand cache of the
kernel-calling blocks, the RPB gather, and the network shell around the
RHAG stack: shallow conv, final norm, body conv, pixel-shuffle tail).

Convolutions keep torch's ``nn.Conv2d`` parameters (OIHW) so checkpoints
load as they are, and run on ``x.permute(0, 3, 1, 2)``: a channels_last
view of the NHWC activation, which cuDNN takes without a copy; the output,
permuted back, is NHWC-contiguous again.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from super_resolution_tpu_torch.ops.attention import (
    relative_position_index_oca, relative_position_index_sa)
from super_resolution_tpu_torch.ops.cuda_ffn import layer_norm_f32
from super_resolution_tpu_torch.ops.pixelshuffle import pixel_shuffle
from super_resolution_tpu_torch.ops.streamed_tail import streamed_rows

LN_EPS = 1e-5  # torch nn.LayerNorm default


def gelu_exact(x):
    """Exact (erf) GELU, torch's nn.GELU default."""
    return F.gelu(x)


def conv_nhwc(conv: nn.Conv2d, x):
    """Apply ``conv`` to an NHWC tensor; returns NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight, conv.bias, conv.stride,
                 conv.padding, conv.dilation, conv.groups)
    return y.permute(0, 2, 3, 1)


def layer_norm(norm: nn.LayerNorm, x):
    """``norm`` with float32 statistics, in x's dtype."""
    return layer_norm_f32(x, norm.weight, norm.bias, norm.eps)


def index_buffer(index) -> torch.Tensor:
    return torch.from_numpy(index).long()


def gather_bias(table, rpi, heads: int) -> torch.Tensor:
    """RPB table[rpi] as a contiguous (heads, Nq, Nk) float32 tensor."""
    nq, nk = rpi.shape
    bias = table[rpi.reshape(-1)].reshape(nq, nk, heads)
    return bias.permute(2, 0, 1).float().contiguous()


class KernelOperands(nn.Module):
    """Caches the operands a block hands its kernels (weights transposed to
    the (in, out) layout, the gathered RPB) while no gradient is recorded;
    they are rebuilt when a parameter changes, moves or is cast."""

    def _build_operands(self) -> dict:
        raise NotImplementedError

    def kernel_operands(self) -> dict:
        if torch.is_grad_enabled():
            return self._build_operands()
        # inference tensors keep no version counter
        key = tuple((p.data_ptr(), 0 if p.is_inference() else p._version,
                     p.dtype, p.device) for p in self.parameters())
        cache = self.__dict__.get("_operand_cache")
        if cache is None or cache[0] != key:
            cache = (key, self._build_operands())
            self.__dict__["_operand_cache"] = cache
        return cache[1]


def mlp_operands(norm: nn.LayerNorm, fc1: nn.Linear, fc2: nn.Linear) -> tuple:
    """The operands of ``mlp_block`` and its sum3 forms."""
    return (norm.weight, norm.bias, fc1.weight.t().contiguous(), fc1.bias,
            fc2.weight.t().contiguous(), fc2.bias)


class PatchEmbedNorm(nn.Module):
    def __init__(self, dim: int, use_norm: bool = True):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=LN_EPS) if use_norm else None

    def forward(self, x):
        return layer_norm(self.norm, x) if self.norm is not None else x


class MeanShift:
    """DIV2K RGB mean shift."""

    RGB_MEAN = (0.4488, 0.4371, 0.4040)

    @staticmethod
    def normalize(x, img_range: float = 1.0):
        mean = torch.tensor(MeanShift.RGB_MEAN, dtype=x.dtype, device=x.device)
        return (x - mean) * img_range

    @staticmethod
    def denormalize(x, img_range: float = 1.0):
        mean = torch.tensor(MeanShift.RGB_MEAN, dtype=x.dtype, device=x.device)
        return x / img_range + mean


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialisation in the official HAT scheme: Linear weights and
    relative-position-bias tables truncated normal (std 0.02), Linear
    biases 0, LayerNorm 1 and 0, convolutions torch's default uniform
    bound 1/sqrt(fan_in). A module with a ``seeded_init(generator)`` method
    then sets what is its own (an orthogonal filter, a zero-initialised
    head). All draws come from ``generator``, so a seed gives the same
    weights on every device."""
    for name, p in module.named_parameters():
        if name.endswith("relative_position_bias_table"):
            nn.init.trunc_normal_(p, std=0.02, generator=generator)
    for m in module.modules():
        if isinstance(m, nn.Linear):
            nn.init.trunc_normal_(m.weight, std=0.02, generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.Conv1d, nn.Conv2d)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            nn.init.uniform_(m.weight, -bound, bound, generator=generator)
            if m.bias is not None:
                nn.init.uniform_(m.bias, -bound, bound, generator=generator)
    for m in module.modules():
        if hasattr(m, "seeded_init"):
            m.seeded_init(generator)


class HATShell(nn.Module):
    """What the classic HAT and the fork's HAT share around their RHAG
    stacks: shallow conv -> [layers] -> norm, body conv and global residual
    -> pixel-shuffle reconstruction, under the checkpoints' names. Input
    and output are NHWC. A subclass builds ``layers`` and hands them over.

    Weights start at torch's defaults; :func:`init_weights` gives the seeded
    initialisation, a checkpoint gives trained ones.
    """

    def __init__(self, layers: Sequence[nn.Module], in_chans: int,
                 embed_dim: int, window_size: int, overlap_ratio: float,
                 patch_norm: bool, upscale: int, img_range: float,
                 upsampler: str, resi_connection: str, stream_tail_rows: int):
        super().__init__()
        if upsampler != "pixelshuffle":
            raise NotImplementedError("only the 'pixelshuffle' upsampler")
        num_feat = 64
        self.img_range = img_range
        self.upscale = upscale
        self.window_size = window_size
        # >0: run the reconstruction tail over row bands of this height
        # (ops/streamed_tail.py), which bounds its activation peak. Exact.
        self.stream_tail_rows = stream_tail_rows
        self.conv_first = nn.Conv2d(in_chans, embed_dim, 3, 1, 1)
        self.patch_embed = PatchEmbedNorm(embed_dim, patch_norm)
        self.layers = nn.ModuleList(layers)
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.conv_after_body = (nn.Conv2d(embed_dim, embed_dim, 3, 1, 1)
                                if resi_connection == "1conv" else None)
        self.conv_before_upsample = nn.Sequential(
            nn.Conv2d(embed_dim, num_feat, 3, 1, 1), nn.LeakyReLU(inplace=True))
        if upscale & (upscale - 1) == 0:
            steps = [2] * int(math.log2(upscale))
        elif upscale == 3:
            steps = [3]
        else:
            raise ValueError(f"upscale {upscale} unsupported")
        up = []
        for r in steps:
            up += [nn.Conv2d(num_feat, r * r * num_feat, 3, 1, 1),
                   nn.PixelShuffle(r)]
        self.upsample = nn.Sequential(*up)
        self.conv_last = nn.Conv2d(num_feat, in_chans, 3, 1, 1)
        # index buffers of the checkpoints, kept so those load strictly;
        # each attention module holds its own copy
        self.register_buffer("relative_position_index_SA", index_buffer(
            relative_position_index_sa(window_size)))
        self.register_buffer("relative_position_index_OCA", index_buffer(
            relative_position_index_oca(window_size, overlap_ratio)))

    def recon(self, f):
        """Reconstruction tail: conv + LeakyReLU, [conv, shuffle]*, conv."""
        y = F.leaky_relu(conv_nhwc(self.conv_before_upsample[0], f), 0.01)
        for i in range(0, len(self.upsample), 2):
            conv, shuffle = self.upsample[i], self.upsample[i + 1]
            y = pixel_shuffle(conv_nhwc(conv, y), shuffle.upscale_factor)
        return conv_nhwc(self.conv_last, y)

    def forward(self, x):
        x = MeanShift.normalize(x, self.img_range)
        feat = conv_nhwc(self.conv_first, x).contiguous()
        body = self.patch_embed(feat)
        for layer in self.layers:
            body = layer(body)
        body = layer_norm(self.norm, body)
        if self.conv_after_body is not None:
            body = conv_nhwc(self.conv_after_body, body)
        feat = body + feat
        if self.stream_tail_rows:
            y = streamed_rows(self.recon, feat, self.upscale,
                              self.stream_tail_rows)
        else:
            y = self.recon(feat)
        return MeanShift.denormalize(y, self.img_range)
