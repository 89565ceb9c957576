"""SwinIR, the window-MSA SR network, NHWC (port of
super_resolution_tpu/models/swinir_arch.py).

Module and parameter names follow the official torch checkpoints
(``layers.0.residual_group.blocks.1.attn.qkv.weight``,
``conv_after_body.{0,2,4}``, ``conv_before_upsample.0``, ``upsample.0``,
``conv_up1``, ``conv_hr``, ``conv_last``, ``patch_embed.norm``, ``norm``),
so an official state_dict loads with ``strict=True`` through
``runtime.sr_model.load_state_dict``, which passes over the ``attn_mask``
and ``attn.relative_position_index`` buffers the files carry.

Every block goes through the kernels of the classic HAT
(``ops/cuda_attention.py``, ``ops/cuda_ffn.py``): an unshifted block calls
``fused_msa_block``, a shifted one ``fused_msa_block_shifted`` (the roll
folded into the kernel; its output stays in rolled space and is rolled
back), then the residual and ``mlp_block``. Each wrapper runs its plain
PyTorch version for a CPU tensor and, for a CUDA tensor, launches its
kernel or raises a ``ValueError`` that names the limit. The three are
called through their ``*_ad`` entries (the kernel forward, autograd
through the plain version backward), so that a block trains, as the arb
SwinIR encoder does.

Training (JAX ``swinir_arch.py:102-115``, ``:201-218``): block i of the
network has the drop-path rate linspace(0, drop_path_rate, blocks)[i]. In
training mode a block whose rate is above 0 keeps its attention kernel,
drops its attention branch, and runs its MLP unfused with drop path (JAX's
route); every other block, and every block in eval mode, runs
``mlp_block``. The draws, and ``use_checkpoint``'s per-RSTB remat, are
``arch_util.SRShell.run_layers``'s.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from super_resolution_tpu_torch.models.arch_util import (LN_EPS,
                                                         DropPathBlock,
                                                         DropPathGroup,
                                                         KernelOperands,
                                                         SRShell,
                                                         apply_residual_conv,
                                                         drop_path,
                                                         layer_norm,
                                                         mlp_operands,
                                                         residual_conv,
                                                         run_blocks)
from super_resolution_tpu_torch.models.hat_classic_arch import (
    Mlp, WindowAttentionClassic)
from super_resolution_tpu_torch.ops.attention import shift_attn_mask_tensor
from super_resolution_tpu_torch.ops.cuda_attention import (
    fused_msa_block_ad, fused_msa_block_shifted_ad)
from super_resolution_tpu_torch.ops.cuda_ffn import mlp_block_ad
from super_resolution_tpu_torch.utils.registry import ARCH_REGISTRY


class SwinTransformerBlock(KernelOperands, DropPathBlock):
    """norm1 -> (shifted) window MSA -> residual -> norm2 -> MLP ->
    residual; in training mode at a rate above 0 with drop path on both
    branches (:meth:`takes_draws`)."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 shift_size: int = 0, mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.shift_size = shift_size
        self.drop_path_rate = drop_path_rate
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttentionClassic(dim, window_size, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def _build_operands(self) -> dict:
        at = self.attn
        return {
            "msa": (at.qkv.weight.t().contiguous(), at.qkv.bias,
                    at.proj.weight.t().contiguous(), at.proj.bias,
                    at.bias()),
            "tail": mlp_operands(self.norm2, self.mlp.fc1, self.mlp.fc2),
        }

    def forward(self, x, draws=None):
        """``draws``: (2, B) uniform draws of the attention and MLP
        branches' drop path, given where :meth:`takes_draws`."""
        _, h, w, c = x.shape
        ws, ss = self.window_size, self.shift_size
        ops = self.kernel_operands()
        kw = dict(heads=self.num_heads, window_size=ws,
                  scale=(c // self.num_heads) ** -0.5)
        x = x.contiguous()
        xn = layer_norm(self.norm1, x)
        if ss > 0:
            mask = shift_attn_mask_tensor(h, w, ws, ss, str(x.device))
            attn = fused_msa_block_shifted_ad(xn, *ops["msa"], mask,
                                              shift=ss, **kw)
            attn = torch.roll(attn, (ss, ss), dims=(1, 2))
        else:
            attn = fused_msa_block_ad(xn, *ops["msa"], **kw)
        if not self.takes_draws():
            return mlp_block_ad((x + attn).contiguous(), *ops["tail"],
                                eps=self.norm2.eps)
        rate = self.drop_path_rate
        x = x + drop_path(attn, rate, draws[0])
        return x + drop_path(self.mlp(layer_norm(self.norm2, x)), rate,
                             draws[1])


class BasicLayer(nn.Module):
    """A group's blocks, alternately unshifted and shifted by half a
    window; block i has drop-path rate ``drop_path_rates[i]`` (0 where the
    list is empty)."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size: int, mlp_ratio: float = 4.0,
                 drop_path_rates: Sequence[float] = ()):
        super().__init__()
        rates = list(drop_path_rates) or [0.0] * depth
        self.blocks = nn.ModuleList([
            SwinTransformerBlock(dim, num_heads, window_size,
                                 0 if i % 2 == 0 else window_size // 2,
                                 mlp_ratio, rates[i])
            for i in range(depth)])

    def forward(self, x, draws=None):
        return run_blocks(self.blocks, x, draws)


class RSTB(DropPathGroup):
    """Residual Swin Transformer block: residual_group -> conv (``1conv``
    or ``3conv``) -> + skip."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size: int, mlp_ratio: float = 4.0,
                 resi_connection: str = "1conv",
                 drop_path_rates: Sequence[float] = ()):
        super().__init__()
        if resi_connection not in ("1conv", "3conv"):
            raise ValueError(f"Unknown resi_connection: {resi_connection}")
        self.residual_group = BasicLayer(dim, depth, num_heads, window_size,
                                         mlp_ratio, drop_path_rates)
        self.conv = residual_conv(dim, resi_connection)

    def forward(self, x, draws=None):
        return apply_residual_conv(self.conv,
                                   self.residual_group(x, draws)) + x


@ARCH_REGISTRY.register()
class SwinIR(SRShell):
    """SwinIR: shallow conv -> RSTBs -> norm, body conv and global residual
    -> reconstruction (``arch_util.SRShell``): ``pixelshuffle`` (classical
    SR, x2, x3, x4), ``pixelshuffledirect`` (lightweight), ``nearest+conv``
    (real-world, x4) or ``""`` (denoising and JPEG artefact removal: the
    input plus a last conv). Input and output are NHWC; an input that is no
    window multiple is reflect-padded at the bottom and the right, and the
    output is cropped by ``upscale`` whatever the head, as the reference
    does. Three input channels are mean-shifted, one is only scaled.

    ``drop_path_rate`` and ``use_checkpoint`` act in training mode only (the
    module docstring); ``forward(x, generator=g)`` draws the drop path from
    ``g``.

    Weights start at torch's defaults; ``models.arch_util.init_weights``
    gives the seeded initialisation, a checkpoint gives trained ones.
    """

    def __init__(self, img_size: int = 64, in_chans: int = 3,
                 embed_dim: int = 96, depths: Sequence[int] = (6, 6, 6, 6),
                 num_heads: Sequence[int] = (6, 6, 6, 6),
                 window_size: int = 7, mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.1, patch_norm: bool = True,
                 upscale: int = 2, img_range: float = 1.0,
                 upsampler: str = "", resi_connection: str = "1conv",
                 use_checkpoint: bool = False):
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        starts = np.cumsum([0, *depths]).tolist()
        layers = [
            RSTB(embed_dim, depth, num_heads[i], window_size, mlp_ratio,
                 resi_connection, dpr[starts[i]:starts[i] + depth])
            for i, depth in enumerate(depths)]
        super().__init__(layers, in_chans, embed_dim, window_size, patch_norm,
                         upscale, img_range, upsampler, resi_connection,
                         pad_mode="reflect")
        self.crop_scale = upscale
        self.use_checkpoint = use_checkpoint
