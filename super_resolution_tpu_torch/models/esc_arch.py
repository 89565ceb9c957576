"""ESC convolutional attention, NHWC: the parts of
super_resolution_tpu/models/esc_arch.py that the fork's HAT builds on
(``orthogonal_oihw``, ``ConvolutionalAttention``, ``SplitPointwise``,
``ConvAttnWrapper``). The ESC network itself is not ported yet.

Module and parameter names follow the torch checkpoints (``plk.dwc_proj.1``,
``aggr``), so their tensors load as they are.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from super_resolution_tpu_torch.models.arch_util import (KernelOperands,
                                                         gelu_exact)
from super_resolution_tpu_torch.ops.conv import (conv2d_nhwc,
                                                 dynamic_depthwise_conv3x3)


@torch.no_grad()
def orthogonal_oihw(tensor: torch.Tensor, generator: torch.Generator):
    """Fill an OIHW conv filter so that its (O, I*kh*kw) flattening has
    orthonormal rows (or columns, when O is the larger side), as
    ``torch.nn.init.orthogonal_`` does, with every draw from ``generator``."""
    o = tensor.shape[0]
    n = tensor[0].numel()
    flat = torch.empty((max(o, n), min(o, n))).normal_(generator=generator)
    q, r = torch.linalg.qr(flat)
    q = q * torch.sign(torch.diagonal(r))  # a unique, sign-fixed factor
    if o < n:
        q = q.t()
    tensor.copy_(q.reshape(tensor.shape))
    return tensor


class ConvolutionalAttention(nn.Module):
    """Static large-kernel conv plus a per-sample dynamic 3x3 depthwise conv
    on the first ``pdim`` channels. The dynamic kernels come from a small
    head on the slab's global average: 1x1 -> GELU -> 1x1, the last layer
    zero-initialised (``dwc_proj``, under the checkpoints' Sequential
    names)."""

    def __init__(self, pdim: int, kernel_size: int = 13):
        super().__init__()
        self.pdim = pdim
        self.kernel_size = kernel_size
        self.dwc_proj = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Conv2d(pdim, pdim // 2, 1),
            nn.GELU(), nn.Conv2d(pdim // 2, pdim * 9, 1))
        self.seeded_init(None)

    @torch.no_grad()
    def seeded_init(self, generator) -> None:
        nn.init.zeros_(self.dwc_proj[3].weight)
        nn.init.zeros_(self.dwc_proj[3].bias)

    def attended(self, x1, lk_filter):
        """The processed slab, from the compact (B, H, W, pdim) slab of the
        first pdim channels (no concat with the passthrough channels)."""
        down, up = self.dwc_proj[1], self.dwc_proj[3]
        g = x1.float().mean(dim=(1, 2)).to(x1.dtype)          # (B, pdim)
        dk = gelu_exact(F.linear(g, down.weight.flatten(1), down.bias))
        dk = F.linear(dk, up.weight.flatten(1), up.bias)      # (B, pdim*9)
        dk = dk.reshape(-1, self.pdim, 3, 3).permute(0, 2, 3, 1)
        dyn = dynamic_depthwise_conv3x3(x1, dk)
        stat = conv2d_nhwc(x1, lk_filter.to(x1.dtype))
        return stat + dyn


class SplitPointwise(KernelOperands, nn.Conv2d):
    """A 1x1 conv over the virtual concat([y1, x[..., split:]]) that is
    never built. The parameters are those of ``nn.Conv2d(in_features, dim,
    1)``. The weight is split at ``split`` input channels: y1 meets the
    first rows, and the full-width x meets the weight with those rows
    zeroed, instead of a strided slice of its passthrough channels: the
    same sum, with no slice copy."""

    def __init__(self, dim: int, split: int, in_features: int):
        super().__init__(in_features, dim, 1)
        self.split = split

    def _build_operands(self) -> dict:
        w = self.weight.flatten(1).t()                        # (Cin, dim)
        rest = w.clone()
        rest[:self.split] = 0
        return {"slab": w[:self.split].contiguous(), "rest": rest}

    def forward(self, y1, x):
        ops = self.kernel_operands()
        return (y1 @ ops["slab"].to(y1.dtype) + x @ ops["rest"].to(x.dtype)
                + self.bias.to(x.dtype))


class ConvAttnWrapper(nn.Module):
    """ConvolutionalAttention + the 1x1 aggregation over [attended slab,
    passthrough channels]."""

    def __init__(self, dim: int, pdim: int, kernel_size: int = 13):
        super().__init__()
        self.pdim = pdim
        self.plk = ConvolutionalAttention(pdim, kernel_size)
        self.aggr = SplitPointwise(dim, pdim, dim)

    def forward(self, x, lk_filter, x1=None):
        """x: (B, H, W, dim); x1: its first pdim channels as a compact
        tensor, where the caller already has them."""
        if x1 is None:
            x1 = x[..., :self.pdim].contiguous()
        return self.aggr(self.plk.attended(x1, lk_filter), x)
