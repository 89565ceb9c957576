"""HAT, the fork's variant (port of super_resolution_tpu/models/hat_arch.py):
the HAB's window self-attention is ESC convolutional attention, its MLP a
gated depthwise-conv FFN and its channel attention ECA; only the OCAB keeps
windowed cross-attention with a relative position bias, optionally with its
keys and values taken from an ESC feature image.

Module and parameter names follow the fork's torch checkpoints
(``layers.0.residual_group.blocks.1.esc_attn.core.plk.dwc_proj.1.weight``,
...), so a state_dict under those names loads with ``strict=True``.
Activations are NHWC throughout.

Kernels per RHAG: each HAB calls ``ln_split`` (front LayerNorm plus the ESC
slab) and ``gated_dconv_ffn_block`` (the whole FFN residual); the OCAB
calls ``fused_ocab_attention`` when ``esc_enable`` is set, else
``fused_ocab_block``, and then ``mlp_block``. With
``front_route="hab_front"`` each HAB calls ``hab_front`` (LayerNorm, the
CAB's two convs and both global pools in one kernel) in place of
``ln_split`` and the CAB's cuDNN convs. Each wrapper runs its plain
PyTorch version for a CPU tensor and launches its CUDA kernel for a CUDA
tensor.

Training (JAX ``hat_arch.py:164-211``, ``:552-583``): block i of the
network has the drop-path rate linspace(0, drop_path_rate, blocks)[i]. In
training mode a HAB whose rate is above 0 runs the unfused modules, with
drop path on its attention and FFN branches; every other HAB, and every
HAB in eval mode, runs the kernels. The kernels of both routes
(``ln_split`` or ``hab_front``, ``gated_dconv_ffn_block``,
``fused_ocab_block`` or, with ``esc_enable``, ``fused_ocab_attention``,
and ``mlp_block``) are called through their ``*_ad`` entries, whose
backward is autograd through the plain version. The drop-path draws and
``use_checkpoint``'s per-RHAG remat are ``arch_util.SRShell.run_layers``'s.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from super_resolution_tpu_torch.models.arch_util import (LN_EPS,
                                                         DropPathBlock,
                                                         DropPathGroup,
                                                         HATShell,
                                                         KernelOperands,
                                                         conv_nhwc,
                                                         drop_path,
                                                         gather_bias,
                                                         gelu_exact,
                                                         index_buffer,
                                                         layer_norm,
                                                         mlp_operands,
                                                         run_blocks)
from super_resolution_tpu_torch.models.esc_arch import (ConvAttnWrapper,
                                                        orthogonal_oihw)
from super_resolution_tpu_torch.ops.attention import \
    relative_position_index_oca
from super_resolution_tpu_torch.ops.cuda_attention import (
    fused_ocab_attention_ad, fused_ocab_block_ad)
from super_resolution_tpu_torch.ops.cuda_ffn import (
    ffn_reference, gated_dconv_ffn_block_ad, mlp_block_ad)
from super_resolution_tpu_torch.ops.cuda_hab import hab_front_ad, ln_split_ad
from super_resolution_tpu_torch.parallel.tp import tp_route_for
from super_resolution_tpu_torch.parallel.tp_ffn import \
    hidden_parallel_mlp_block
from super_resolution_tpu_torch.utils.registry import ARCH_REGISTRY

FRONT_ROUTES = ("ln_split", "hab_front")


class ECA(nn.Module):
    """Efficient channel attention: GAP -> conv1d(k) over the channel axis
    -> sigmoid gate."""

    def __init__(self, k_size: int = 5):
        super().__init__()
        self.conv = nn.Conv1d(1, 1, k_size, padding=k_size // 2, bias=False)

    def forward(self, x, mean=None):
        """``mean``: the (B, C) pixel mean of the gated input, where the
        caller already has it (it may gate a scaled copy of that input)."""
        y = x.mean(dim=(1, 2)) if mean is None else mean      # (B, C)
        y = torch.sigmoid(self.conv(y[:, None, :])[:, 0])
        return x * y[:, None, None, :]


class CAB(nn.Module):
    """Conv block: 3x3 compress -> GELU -> 3x3 expand -> ECA, under the
    checkpoints' Sequential names ('cab.{0,2,3}')."""

    def __init__(self, num_feat: int, compress_ratio: int = 3):
        super().__init__()
        mid = num_feat // compress_ratio
        self.cab = nn.Sequential(
            nn.Conv2d(num_feat, mid, 3, 1, 1), nn.GELU(),
            nn.Conv2d(mid, num_feat, 3, 1, 1), ECA(5))

    def forward(self, x):
        y = conv_nhwc(self.cab[2], gelu_exact(conv_nhwc(self.cab[0], x)))
        return self.cab[3](y)


class GatedDconvFFN(nn.Module):
    """fc1 -> depthwise 3x3 -> SiLU-gated GLU -> fc2. The HAB runs it through
    the fused kernel (``gated_dconv_ffn_block``, from :meth:`operands`);
    ``forward`` is the unfused route of a HAB with drop path."""

    def __init__(self, dim: int, mlp_ratio: float = 2.0):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.fc1 = nn.Linear(dim, 2 * hidden)
        self.dw = nn.Conv2d(2 * hidden, 2 * hidden, 3, 1, 1,
                            groups=2 * hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def operands(self) -> tuple:
        """w1 (C, 2M), b1, wd (3, 3, 2M), bd, w2 (M, C), b2."""
        return (self.fc1.weight.t().contiguous(), self.fc1.bias,
                self.dw.weight[:, 0].permute(1, 2, 0).contiguous(),
                self.dw.bias, self.fc2.weight.t().contiguous(),
                self.fc2.bias)

    def forward(self, x):
        return ffn_reference(x, *self.operands())


class ESCConvAttn(nn.Module):
    """The HAB's attention branch: a ConvAttnWrapper with its own
    orthogonally initialised large-kernel filter."""

    def __init__(self, dim: int, pdim: int = 16, kernel_size: int = 13):
        super().__init__()
        self.core = ConvAttnWrapper(dim, pdim, kernel_size)
        self.plk_filter = nn.Parameter(
            torch.zeros(pdim, pdim, kernel_size, kernel_size))

    def seeded_init(self, generator: torch.Generator) -> None:
        orthogonal_oihw(self.plk_filter, generator)

    def forward(self, x, x1=None, mean=None):
        return self.core(x, self.plk_filter, x1, mean)


class HAB(KernelOperands, DropPathBlock):
    """Hybrid attention block of the fork: norm1 -> {ESC conv attention +
    conv_scale * CAB} residual, then the gated depthwise-conv FFN residual.
    ``num_heads``, ``window_size``, ``shift_size`` and ``squeeze_factor``
    are taken for the options' sake; the conv attention uses none.

    ``front_route`` picks the kernels of the first residual: ``ln_split``
    (the LayerNorm kernel, then the CAB's convs in cuDNN) or ``hab_front``
    (one kernel up to the two global pools, whose sums feed the ECA gate
    and the dynamic-kernel head; it needs dim > esc_pdim). In training mode
    with ``drop_path_rate`` above 0 the block runs the unfused modules
    instead (:meth:`takes_draws`)."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 shift_size: int = 0, compress_ratio: int = 3,
                 squeeze_factor: int = 30, conv_scale: float = 0.01,
                 mlp_ratio: float = 4.0, esc_pdim: int = 16,
                 esc_kernel: int = 13, front_route: str = "ln_split",
                 drop_path_rate: float = 0.0):
        super().__init__()
        if front_route not in FRONT_ROUTES:
            raise ValueError(f"front_route {front_route!r}: one of "
                             f"{FRONT_ROUTES}")
        if front_route == "hab_front" and dim <= esc_pdim:
            raise ValueError(f"front_route 'hab_front' needs dim > esc_pdim, "
                             f"got {dim} and {esc_pdim}")
        self.front_route = front_route
        self.conv_scale = conv_scale
        self.esc_pdim = esc_pdim
        self.drop_path_rate = drop_path_rate
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.esc_attn = ESCConvAttn(dim, esc_pdim, esc_kernel)
        self.conv_block = CAB(dim, compress_ratio)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = GatedDconvFFN(dim, mlp_ratio)

    def _build_operands(self) -> dict:
        cab = self.conv_block.cab
        return {"ffn": (self.norm2.weight, self.norm2.bias,
                        *self.mlp.operands()),
                # the CAB's convs as HWIO filters
                "front": (self.norm1.weight, self.norm1.bias,
                          cab[0].weight.permute(2, 3, 1, 0).contiguous(),
                          cab[0].bias,
                          cab[2].weight.permute(2, 3, 1, 0).contiguous(),
                          cab[2].bias)}

    def forward(self, x, draws=None):
        """``draws``: (2, B) uniform draws of the attention and FFN branches'
        drop path, given where :meth:`takes_draws`."""
        x = x.contiguous()
        if self.takes_draws():
            return self._unfused(x, draws)
        ops = self.kernel_operands()
        if self.front_route == "hab_front":
            x = self._hab_front(x, ops)
        else:
            ln1, x1 = ln_split_ad(x, self.norm1.weight, self.norm1.bias,
                                  eps=self.norm1.eps, pdim=self.esc_pdim)
            conv_x = self.conv_block(ln1)
            attn_x = self.esc_attn(ln1, x1)
            x = x + attn_x + self.conv_scale * conv_x
        return gated_dconv_ffn_block_ad(x.contiguous(), *ops["ffn"],
                                        eps=self.norm2.eps)

    def _unfused(self, x, draws):
        """The modules one by one, drop path on both branches (JAX
        ``HAB.__call__``'s last route)."""
        rate = self.drop_path_rate
        u_attn, u_ffn = draws
        ln1 = layer_norm(self.norm1, x)
        conv_x = self.conv_block(ln1)
        attn_x = self.esc_attn(ln1, ln1[..., :self.esc_pdim].contiguous())
        attn_x = drop_path(attn_x, rate, u_attn)
        x = x + attn_x + conv_x * self.conv_scale
        mlp_x = drop_path(self.mlp(layer_norm(self.norm2, x)), rate, u_ffn)
        return x + mlp_x

    def _hab_front(self, x, ops):
        """The first residual from ``hab_front``'s outputs: the ECA gate
        from the mean of cab_mid, the dynamic-kernel head from the mean of
        the ESC slab, then x + attn_x + conv_scale * cab_mid * gate."""
        pdim = self.esc_pdim
        ln1, cab_mid, gap_cab, gap16 = hab_front_ad(
            x, *ops["front"], eps=self.norm1.eps, pdim=pdim)
        inv_hw = 1.0 / (x.shape[1] * x.shape[2])
        attn_x = self.esc_attn(ln1, ln1[..., :pdim].contiguous(),
                               (gap16 * inv_hw).to(x.dtype))
        conv_x = self.conv_block.cab[3](self.conv_scale * cab_mid,
                                        (gap_cab * inv_hw).to(x.dtype))
        return x + attn_x + conv_x


class OCAB(KernelOperands):
    """Overlapping cross-attention block: Q from ws-windows, K and V from
    overlapping ow-windows (ow = ws + overlap_ratio * ws, zero outside the
    image), attention with a gathered relative position bias, then the MLP
    tail. With ``esc_enable`` K and V are projected from an ESC conv
    attention of the normed input."""

    def __init__(self, dim: int, window_size: int, overlap_ratio: float,
                 num_heads: int, mlp_ratio: float = 2.0,
                 esc_enable: bool = False, esc_pdim: int = 16,
                 esc_kernel: int = 13):
        super().__init__()
        ws = window_size
        self.num_heads = num_heads
        self.window_size = ws
        self.overlap_win_size = int(ws * overlap_ratio) + ws
        ow = self.overlap_win_size
        self.esc_enable = esc_enable
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.q_proj = nn.Linear(dim, dim)
        self.kv_proj = nn.Linear(dim, 2 * dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((ws + ow - 1) * (ws + ow - 1), num_heads))
        self.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = nn.Sequential(nn.Linear(dim, int(dim * mlp_ratio)),
                                 nn.GELU(),
                                 nn.Linear(int(dim * mlp_ratio), dim))
        if esc_enable:
            self.esc_core = ConvAttnWrapper(dim, esc_pdim, esc_kernel)
            self.esc_plk = nn.Parameter(
                torch.zeros(esc_pdim, esc_pdim, esc_kernel, esc_kernel))
        self.register_buffer(
            "rpi", index_buffer(relative_position_index_oca(ws,
                                                            overlap_ratio)),
            persistent=False)

    def seeded_init(self, generator: torch.Generator) -> None:
        if self.esc_enable:
            orthogonal_oihw(self.esc_plk, generator)

    def _build_operands(self) -> dict:
        return {
            "block": (self.norm1.weight, self.norm1.bias,
                      self.q_proj.weight.t().contiguous(), self.q_proj.bias,
                      self.kv_proj.weight.t().contiguous(),
                      self.kv_proj.bias,
                      self.proj.weight.t().contiguous(), self.proj.bias),
            "bias": gather_bias(self.relative_position_bias_table, self.rpi,
                                self.num_heads),
            "tail": mlp_operands(self.norm2, self.mlp[0], self.mlp[2]),
        }

    def forward(self, x):
        c = x.shape[-1]
        ops = self.kernel_operands()
        kw = dict(heads=self.num_heads, window_size=self.window_size,
                  overlap_win=self.overlap_win_size,
                  scale=(c // self.num_heads) ** -0.5)
        x = x.contiguous()
        if self.esc_enable:
            xn = layer_norm(self.norm1, x)
            y = self.esc_core(xn, self.esc_plk)
            q = F.linear(xn, self.q_proj.weight, self.q_proj.bias)
            kv = F.linear(y, self.kv_proj.weight, self.kv_proj.bias)
            out = fused_ocab_attention_ad(q.contiguous(), kv.contiguous(),
                                          ops["bias"], **kw)
            x = F.linear(out, self.proj.weight, self.proj.bias) + x
        else:
            x = fused_ocab_block_ad(x, *ops["block"], ops["bias"], **kw,
                                    ln_eps=self.norm1.eps)
        # under tensor parallelism the tail runs hidden-parallel where the
        # model axis divides its hidden dim (JAX hat_arch.py:406-422)
        tp_hidden = tp_route_for(self.mlp[0].out_features)
        if tp_hidden is not None:
            return hidden_parallel_mlp_block(
                x.contiguous(), *ops["tail"], mesh=tp_hidden[0],
                axis=tp_hidden[1], eps=self.norm2.eps)
        return mlp_block_ad(x.contiguous(), *ops["tail"], eps=self.norm2.eps)


class AttenBlocks(nn.Module):
    """depth x HAB followed by one OCAB; block i has drop-path rate
    ``drop_path_rates[i]`` (0 where the list is empty)."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size: int, compress_ratio: int, squeeze_factor: int,
                 conv_scale: float, overlap_ratio: float,
                 mlp_ratio: float = 4.0, esc_pdim: int = 16,
                 esc_kernel: int = 13, ocab_esc_enable: bool = False,
                 ocab_esc_pdim: int = 16, ocab_esc_kernel: int = 13,
                 front_route: str = "ln_split",
                 drop_path_rates: Sequence[float] = ()):
        super().__init__()
        rates = list(drop_path_rates) or [0.0] * depth
        self.blocks = nn.ModuleList([
            HAB(dim, num_heads, window_size,
                0 if i % 2 == 0 else window_size // 2, compress_ratio,
                squeeze_factor, conv_scale, mlp_ratio, esc_pdim, esc_kernel,
                front_route, rates[i])
            for i in range(depth)])
        self.overlap_attn = OCAB(dim, window_size, overlap_ratio, num_heads,
                                 mlp_ratio, ocab_esc_enable, ocab_esc_pdim,
                                 ocab_esc_kernel)

    def forward(self, x, draws=None):
        """``draws``: (n, 2, B), one (2, B) for each block that takes draws,
        in order."""
        return self.overlap_attn(run_blocks(self.blocks, x, draws))


class RHAG(DropPathGroup):
    """Residual hybrid attention group: AttenBlocks -> 3x3 conv -> + skip."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size: int, compress_ratio: int, squeeze_factor: int,
                 conv_scale: float, overlap_ratio: float,
                 mlp_ratio: float = 4.0, resi_connection: str = "1conv",
                 **esc):
        super().__init__()
        self.residual_group = AttenBlocks(
            dim, depth, num_heads, window_size, compress_ratio,
            squeeze_factor, conv_scale, overlap_ratio, mlp_ratio, **esc)
        if resi_connection == "1conv":
            self.conv = nn.Conv2d(dim, dim, 3, 1, 1)
        elif resi_connection == "identity":
            self.conv = None
        else:
            raise ValueError(f"Unknown resi_connection: {resi_connection}")

    def forward(self, x, draws=None):
        y = self.residual_group(x, draws)
        if self.conv is not None:
            y = conv_nhwc(self.conv, y)
        return y + x


@ARCH_REGISTRY.register()
class HAT(HATShell):
    """Hybrid Attention Transformer, the fork's variant: NHWC RGB in [0, 1]
    -> NHWC upscaled RGB. ``drop_path_rate`` and ``use_checkpoint`` act in
    training mode only (the module docstring); ``forward(x, generator=g)``
    draws the drop path from ``g`` (torch's default generator where None).

    ``front_route`` (``ln_split`` or ``hab_front``) picks the kernels of
    every HAB's first residual (:class:`HAB`); the default is ``ln_split``.

    Weights start at torch's defaults; ``models.arch_util.init_weights``
    gives the seeded initialisation, a checkpoint gives trained ones.
    """

    def __init__(self, img_size: int = 64, in_chans: int = 3,
                 embed_dim: int = 96, depths: Sequence[int] = (6, 6, 6, 6),
                 num_heads: Sequence[int] = (6, 6, 6, 6),
                 window_size: int = 7, compress_ratio: int = 3,
                 squeeze_factor: int = 30, conv_scale: float = 0.01,
                 overlap_ratio: float = 0.5, mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.1, patch_norm: bool = True,
                 upscale: int = 2, img_range: float = 1.0,
                 upsampler: str = "pixelshuffle",
                 resi_connection: str = "1conv", esc_pdim: int = 16,
                 esc_kernel: int = 13, ocab_esc_enable: bool = False,
                 ocab_esc_pdim: int = 16, ocab_esc_kernel: int = 13,
                 use_checkpoint: bool = False, stream_tail_rows: int = 0,
                 front_route: str = "ln_split"):
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        starts = np.cumsum([0, *depths]).tolist()
        layers = [
            RHAG(embed_dim, depth, num_heads[i], window_size, compress_ratio,
                 squeeze_factor, conv_scale, overlap_ratio, mlp_ratio,
                 resi_connection, esc_pdim=esc_pdim, esc_kernel=esc_kernel,
                 ocab_esc_enable=ocab_esc_enable,
                 ocab_esc_pdim=ocab_esc_pdim,
                 ocab_esc_kernel=ocab_esc_kernel, front_route=front_route,
                 drop_path_rates=dpr[starts[i]:starts[i] + depth])
            for i, depth in enumerate(depths)]
        super().__init__(layers, in_chans, embed_dim, window_size,
                         overlap_ratio, patch_norm, upscale, img_range,
                         upsampler, resi_connection, stream_tail_rows)
        self.use_checkpoint = use_checkpoint
