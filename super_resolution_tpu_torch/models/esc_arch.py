"""ESC, Emulating Self-attention with Convolution, NHWC (port of
super_resolution_tpu/models/esc_arch.py): the convolutional attention that
the fork's HAT builds on as well (``orthogonal_oihw``,
``ConvolutionalAttention``, ``SplitPointwise``, ``ConvAttnWrapper``) and
the ESC network (``ConvFFN``, ``WindowAttentionESC``, ``Block``, ``ESC``).

Module and parameter names follow the torch checkpoints
(``blocks.0.attn.to_qkv``, ``blocks.0.pconvs.0.plk.dwc_proj.1``,
``blocks.0.lns.0``, ``plk_filter``, ``attn.relative_position_bias``), so
their tensors load as they are.

The window attention has one route per shape (:func:`esc_attention_route`):
the ``fused_msa_block`` kernel with the 1x1 projections inside where one
head of a window fits its shared memory, else a plain qkv matmul and
``fused_attention`` on cut windows, else ``msa_flash_attention`` on the qkv
image. Each wrapper runs its plain PyTorch version for a CPU tensor and
launches its CUDA kernel for a CUDA tensor. The three are called through
their ``*_ad`` entries, so that the network trains: on the card the kernel
runs forward and the backward is autograd through the plain version. Of
the forced A/B routes, ``msa_qtile_attention`` trains through its entry as
well; ``fused_attention_v3`` has no backward on the card (JAX has no entry
for it either) and raises under a gradient.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from super_resolution_tpu_torch.models.arch_util import (KernelOperands,
                                                         conv_nhwc,
                                                         gelu_exact,
                                                         index_buffer,
                                                         layer_norm)
from super_resolution_tpu_torch.ops.conv import (conv2d_nhwc,
                                                 dynamic_depthwise_conv3x3)
from super_resolution_tpu_torch.ops.cuda_attention import (
    fused_msa_block_ad, msa_block_supported)
from super_resolution_tpu_torch.ops.cuda_window_attention import (
    fused_attention_ad, fused_attention_supported, fused_attention_v3,
    fused_attention_v3_supported, msa_flash_attention_ad,
    msa_flash_supported, msa_qtile_attention_ad, msa_qtile_supported,
    window_attention_fused)
from super_resolution_tpu_torch.ops.pixelshuffle import pixel_shuffle
from super_resolution_tpu_torch.ops.windowing import (pad_to_multiple,
                                                      window_partition,
                                                      window_reverse)
from super_resolution_tpu_torch.utils.registry import ARCH_REGISTRY

ESC_LN_EPS = 1e-6


def geo_ensemble(k):
    """Mean of an OIHW filter over its eight flips and quarter turns: the
    geometric re-parameterisation of the large kernel."""
    rot = torch.rot90(k, -1, (2, 3))
    return (k + k.flip(3) + k.flip(2) + k.flip(2, 3)
            + rot + rot.flip(3) + rot.flip(2) + rot.flip(2, 3)) / 8.0


def esc_rpe_index(window_size: int) -> np.ndarray:
    """(N, N) index into ESC's transposed-Swin relative position table (a
    copy of the JAX package's numpy function)."""
    ws = window_size
    idx = np.arange(ws * ws)
    qh, qw = idx // ws, idx % ws
    rel_h = qh[None, :] - qh[:, None] + ws - 1
    rel_w = qw[None, :] - qw[:, None] + ws - 1
    return (rel_h * (2 * ws - 1) + rel_w).astype(np.int32)


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

    def attended(self, x1, lk_filter, mean=None):
        """The processed slab, from the compact (B, H, W, pdim) slab of the
        first pdim channels (no concat with the passthrough channels).
        ``mean``: the slab's (B, pdim) pixel mean in x1's dtype, where the
        caller already has it."""
        down, up = self.dwc_proj[1], self.dwc_proj[3]
        g = (x1.float().mean(dim=(1, 2)).to(x1.dtype) if mean is None
             else mean)                                       # (B, pdim)
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

    def forward(self, x, lk_filter, x1=None, mean=None):
        """x: (B, H, W, dim); x1: its first pdim channels as a compact
        tensor, and ``mean`` their pixel mean, where the caller already has
        them."""
        if x1 is None:
            x1 = x[..., :self.pdim].contiguous()
        return self.aggr(self.plk.attended(x1, lk_filter, mean), x)


def pointwise(conv: nn.Conv2d, x):
    """A 1x1 ``conv`` on an NHWC tensor, as a matrix product over the
    channels."""
    return F.linear(x, conv.weight.flatten(1), conv.bias)


class ConvFFN(nn.Module):
    """1x1 expand -> GELU -> depthwise k x k -> GELU + residual -> 1x1
    aggregate."""

    def __init__(self, dim: int, kernel_size: int, exp_ratio: float):
        super().__init__()
        hidden = int(dim * exp_ratio)
        self.proj = nn.Conv2d(dim, hidden, 1)
        self.dwc = nn.Conv2d(hidden, hidden, kernel_size, 1,
                             kernel_size // 2, groups=hidden)
        self.aggr = nn.Conv2d(hidden, dim, 1)

    def forward(self, x):
        x = gelu_exact(pointwise(self.proj, x))
        x = gelu_exact(conv_nhwc(self.dwc, x)) + x
        return pointwise(self.aggr, x)


# attention route -> whether the card can run it at (window, head dim)
ATTENTION_ROUTES = {
    "fused_msa_block": msa_block_supported,
    "fused_attention": lambda ws, d: fused_attention_supported(
        ws * ws, ws * ws, d),
    "fused_attention_v3": lambda ws, d: fused_attention_v3_supported(
        ws * ws, ws * ws, d),
    "msa_flash_attention": msa_flash_supported,
    "msa_qtile_attention": msa_qtile_supported,
}


def esc_attention_route(window_size: int, head_dim: int, dtype) -> str:
    """The kernel ``WindowAttentionESC`` takes for a shape, the same on the
    CPU and on the card: ``fused_msa_block`` where one head of a window
    fits its block (at head dim 16: windows up to 24), else
    ``fused_attention`` on cut windows (ESC's window 32), else
    ``msa_flash_attention`` on the qkv image (ESC-XL's window 48). The
    limits are the card's shared memory and hold for both dtypes the
    kernels take."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the attention kernels take float32 or bfloat16, "
                        f"not {dtype}")
    for route in ("fused_msa_block", "fused_attention",
                  "msa_flash_attention"):
        if ATTENTION_ROUTES[route](window_size, head_dim):
            return route
    raise ValueError(f"no attention kernel for window {window_size}, head "
                     f"dim {head_dim}")


class WindowAttentionESC(KernelOperands):
    """Window multi-head self-attention on NHWC with a reflect pad to a
    window multiple and ESC's relative position table. ``attn_route`` forces
    one of ``ATTENTION_ROUTES``; None takes :func:`esc_attention_route`."""

    def __init__(self, dim: int, window_size: int, num_heads: int,
                 attn_route: str | None = None):
        super().__init__()
        head_dim = dim // num_heads
        if attn_route is not None:
            if attn_route not in ATTENTION_ROUTES:
                raise ValueError(f"unknown attn_route {attn_route!r}; one "
                                 f"of {sorted(ATTENTION_ROUTES)}")
            if not ATTENTION_ROUTES[attn_route](window_size, head_dim):
                raise ValueError(f"attn_route {attn_route!r} cannot run "
                                 f"window {window_size}, head dim "
                                 f"{head_dim} on the card")
        self.dim = dim
        self.window_size = window_size
        self.num_heads = num_heads
        self.attn_route = attn_route
        self.to_qkv = nn.Conv2d(dim, dim * 3, 1)
        self.to_out = nn.Conv2d(dim, dim, 1)
        self.relative_position_bias = nn.Parameter(
            torch.zeros(num_heads, (2 * window_size - 1) ** 2))
        self.register_buffer("rpe_idx",
                             index_buffer(esc_rpe_index(window_size)),
                             persistent=False)

    @torch.no_grad()
    def seeded_init(self, generator: torch.Generator) -> None:
        self.relative_position_bias.copy_(0.001 * torch.empty(
            self.relative_position_bias.shape).normal_(generator=generator))

    def _build_operands(self) -> dict:
        """The dense (heads, N, N) float32 bias (21 MB a head at window 48:
        built once and kept) and the projections as (in, out) matrices."""
        n = self.window_size ** 2
        bias = self.relative_position_bias[:, self.rpe_idx.reshape(-1)]
        return {"bias": bias.reshape(self.num_heads, n, n).float()
                .contiguous(),
                "w_qkv": self.to_qkv.weight.flatten(1).t().contiguous(),
                "w_out": self.to_out.weight.flatten(1).t().contiguous()}

    def forward(self, x):
        _, h, w, c = x.shape
        ws, heads = self.window_size, self.num_heads
        d = c // heads
        x, _ = pad_to_multiple(x, ws)
        hp, wp = x.shape[1], x.shape[2]
        ops = self.kernel_operands()
        route = self.attn_route or esc_attention_route(ws, d, x.dtype)
        if route == "fused_msa_block":
            out = fused_msa_block_ad(
                x.contiguous(), ops["w_qkv"], self.to_qkv.bias, ops["w_out"],
                self.to_out.bias, ops["bias"], heads=heads, window_size=ws,
                scale=d ** -0.5)
            return out[:, :h, :w, :]
        qkv = x @ ops["w_qkv"] + self.to_qkv.bias
        if route == "msa_flash_attention":
            out = msa_flash_attention_ad(qkv, ops["bias"], heads=heads,
                                         window_size=ws, scale=d ** -0.5)
        elif route == "msa_qtile_attention":
            out = msa_qtile_attention_ad(qkv, ops["bias"], heads=heads,
                                         window_size=ws, scale=d ** -0.5)
        else:
            wins = window_partition(qkv, ws).reshape(-1, ws * ws, 3, c)
            out = window_attention_fused(
                wins.permute(2, 0, 1, 3), heads, ops["bias"],
                attention=(fused_attention_v3
                           if route == "fused_attention_v3"
                           else fused_attention_ad))
            out = window_reverse(out.reshape(-1, ws, ws, c), ws, hp, wp)
        return out[:, :h, :w, :] @ ops["w_out"] + self.to_out.bias


class Block(nn.Module):
    """ESC block: ConvFFN proj -> window attention -> conv_blocks x (ConvFFN
    -> convolutional attention) -> 3x3 conv out, all residual."""

    def __init__(self, dim: int, pdim: int, conv_blocks: int,
                 kernel_size: int, window_size: int, num_heads: int,
                 exp_ratio: float, use_ln: bool = False,
                 attn_route: str | None = None):
        super().__init__()

        def ln():
            return nn.LayerNorm(dim, eps=ESC_LN_EPS)

        self.ln_proj = ln()
        self.proj = ConvFFN(dim, 3, 2)
        self.ln_attn = ln()
        self.attn = WindowAttentionESC(dim, window_size, num_heads,
                                       attn_route)
        self.lns = nn.ModuleList([ln() if use_ln else nn.Identity()
                                  for _ in range(conv_blocks)])
        self.pconvs = nn.ModuleList([ConvAttnWrapper(dim, pdim, kernel_size)
                                     for _ in range(conv_blocks)])
        self.convffns = nn.ModuleList([ConvFFN(dim, 3, exp_ratio)
                                       for _ in range(conv_blocks)])
        self.ln_out = ln()
        self.conv_out = nn.Conv2d(dim, dim, 3, 1, 1)

    def forward(self, x, plk_filter):
        skip = x
        x = self.proj(layer_norm(self.ln_proj, x))
        x = x + self.attn(layer_norm(self.ln_attn, x))
        for ln, pconv, convffn in zip(self.lns, self.pconvs, self.convffns):
            y = layer_norm(ln, x) if isinstance(ln, nn.LayerNorm) else x
            x = x + pconv(convffn(y), plk_filter)
        x = conv_nhwc(self.conv_out, layer_norm(self.ln_out, x))
        return x + skip


@ARCH_REGISTRY.register()
class ESC(nn.Module):
    """ESC super-resolution network: NHWC RGB in [0, 1] -> NHWC upscaled
    RGB. 3x3 proj -> n_blocks x Block (which share one geo-ensembled large
    filter) -> 3x3 last + skip -> to_img conv -> pixel shuffle, with the
    input added to every sub-pixel (a nearest-neighbour upsample of it).

    ``attn_type`` (``xla`` | ``pallas``) is the backend switch of the option
    files and selects nothing here. ``deployment`` says the filter was
    ensembled offline. ``attn_route`` forces one attention kernel
    (``ATTENTION_ROUTES``) instead of :func:`esc_attention_route`.

    Weights start at torch's defaults; ``models.arch_util.init_weights``
    gives the seeded initialisation, a checkpoint gives trained ones.
    """

    def __init__(self, dim: int, pdim: int, kernel_size: int, n_blocks: int,
                 conv_blocks: int, window_size: int, num_heads: int,
                 upscaling_factor: int, exp_ratio: float = 2.0,
                 use_ln: bool = False, attn_type: str = "xla",
                 deployment: bool = False, attn_route: str | None = None):
        super().__init__()
        if attn_type not in ("xla", "pallas"):
            raise ValueError(f"attn_type {attn_type!r}: 'xla' or 'pallas'")
        self.upscaling_factor = upscaling_factor
        self.window_size = window_size
        self.deployment = deployment
        self.plk_filter = nn.Parameter(
            torch.zeros(pdim, pdim, kernel_size, kernel_size))
        self.proj = nn.Conv2d(3, dim, 3, 1, 1)
        self.blocks = nn.ModuleList([
            Block(dim, pdim, conv_blocks, kernel_size, window_size,
                  num_heads, exp_ratio, use_ln, attn_route)
            for _ in range(n_blocks)])
        self.last = nn.Conv2d(dim, dim, 3, 1, 1)
        self.to_img = nn.Conv2d(dim, 3 * upscaling_factor ** 2, 3, 1, 1)

    def seeded_init(self, generator: torch.Generator) -> None:
        orthogonal_oihw(self.plk_filter, generator)

    def forward(self, x):
        s = self.upscaling_factor
        feat = conv_nhwc(self.proj, x).contiguous()
        skip = feat
        plk = (self.plk_filter if self.deployment
               else geo_ensemble(self.plk_filter))
        for block in self.blocks:
            feat = block(feat, plk)
        feat = conv_nhwc(self.last, feat) + skip
        out = conv_nhwc(self.to_img, feat) + x.repeat_interleave(s * s, -1)
        return pixel_shuffle(out, s)
