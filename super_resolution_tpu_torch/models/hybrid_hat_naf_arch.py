"""HybridHATNAF, NHWC (port of
super_resolution_tpu/models/hybrid_hat_naf_arch.py): a NAFNet stem (simple
gate blocks with a channel gate on the global mean, residual to the input)
ahead of HATX, which gives the global context and the upsampling.

``ESCConvAttnWrapper`` is the reference adapter's name of the fork HAB's
``ESCConvAttn`` (the JAX module re-exports it the same way). Plain PyTorch:
no kernel, as in JAX.
"""

from __future__ import annotations

import torch
from torch import nn

from super_resolution_tpu_torch.models.arch_util import conv_nhwc
from super_resolution_tpu_torch.models.esc_arch import pointwise
from super_resolution_tpu_torch.models.hat_arch import \
    ESCConvAttn as ESCConvAttnWrapper  # noqa: F401
from super_resolution_tpu_torch.models.hatx_arch import HATX
from super_resolution_tpu_torch.utils.registry import ARCH_REGISTRY


def simple_gate(x):
    a, b = x.chunk(2, dim=-1)
    return a * b


class NAFBlock(nn.Module):
    """PW -> DW -> simple gate -> channel gate -> PW, then the gated FFN
    branch; the learnable ``beta`` and ``gamma`` scale the two residuals
    (zero at init: the block starts as the identity)."""

    def __init__(self, c: int, dw_expand: int = 2, ffn_expand: int = 2):
        super().__init__()
        dwc, ffnc = c * dw_expand, c * ffn_expand
        self.pw1 = nn.Conv2d(c, dwc, 1)
        self.dw = nn.Conv2d(dwc, dwc, 3, 1, 1, groups=dwc)
        self.sca = nn.Sequential(nn.AdaptiveAvgPool2d(1),
                                 nn.Conv2d(dwc // 2, dwc // 2, 1))
        self.pw2 = nn.Conv2d(dwc // 2, c, 1)
        self.ffn1 = nn.Conv2d(c, ffnc, 1)
        self.ffn_dw = nn.Conv2d(ffnc, ffnc, 3, 1, 1, groups=ffnc)
        self.ffn2 = nn.Conv2d(ffnc // 2, c, 1)
        self.beta = nn.Parameter(torch.zeros(c))
        self.gamma = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        y = simple_gate(conv_nhwc(self.dw, pointwise(self.pw1, x)))
        y = y * pointwise(self.sca[1], y.mean(dim=(1, 2), keepdim=True))
        y = x + self.beta * pointwise(self.pw2, y)
        z = simple_gate(conv_nhwc(self.ffn_dw, pointwise(self.ffn1, y)))
        return y + self.gamma * pointwise(self.ffn2, z)


class NAFStem(nn.Module):
    """3x3 head -> NAFBlocks -> 3x3 tail, + the input."""

    def __init__(self, in_ch: int = 3, width: int = 64, n_blocks: int = 4):
        super().__init__()
        self.head = nn.Conv2d(in_ch, width, 3, 1, 1)
        self.body = nn.ModuleList([NAFBlock(width) for _ in range(n_blocks)])
        self.tail = nn.Conv2d(width, in_ch, 3, 1, 1)

    def forward(self, x):
        h = conv_nhwc(self.head, x)
        for blk in self.body:
            h = blk(h)
        return x + conv_nhwc(self.tail, h)


@ARCH_REGISTRY.register()
class HybridHATNAF(nn.Module):
    """NAFStem -> HATX. ``hat_kwargs`` are HATX's arguments (lists become
    tuples); its ``window_size`` is ``window_size`` where given, else its
    own or 8, and its ``upscale`` and ``in_chans`` default to this
    module's. ``forward(x, generator=g)`` hands ``g`` to HATX's drop path.
    """

    def __init__(self, naf_width: int = 64, naf_blocks: int = 4,
                 window_size: int | None = None, upscale: int = 2,
                 in_chans: int = 3, hat_kwargs: dict | None = None):
        super().__init__()
        hk = dict(hat_kwargs or {})
        hk["window_size"] = int(window_size if window_size is not None
                                else hk.get("window_size", 8))
        hk.setdefault("upscale", int(upscale))
        hk.setdefault("in_chans", int(in_chans))
        hk = {k: tuple(v) if isinstance(v, list) else v
              for k, v in hk.items()}
        self.naf = NAFStem(in_chans, naf_width, naf_blocks)
        self.hat = HATX(**hk)

    def forward(self, x, generator: torch.Generator | None = None):
        return self.hat(self.naf(x), generator)
