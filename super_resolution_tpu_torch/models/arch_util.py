"""Shared building blocks of the port's architectures, NHWC: the parts of
super_resolution_tpu/models/arch_util.py the Swin family uses, and what its
networks have in common (the operand cache of the kernel-calling blocks, the
RPB gather, the ConvFFN with a depthwise branch, and the network shell
around the stack of residual groups: shallow conv, final norm, body conv,
reconstruction tail).

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
from torch.utils.checkpoint import checkpoint

from super_resolution_tpu_torch.ops.attention import (
    relative_position_index_oca, relative_position_index_sa)
from super_resolution_tpu_torch.ops.cuda_ffn import layer_norm_f32
from super_resolution_tpu_torch.ops.pixelshuffle import pixel_shuffle
from super_resolution_tpu_torch.ops.streamed_tail import streamed_rows
from super_resolution_tpu_torch.ops.windowing import reflect_pad

LN_EPS = 1e-5  # torch nn.LayerNorm default


def gelu_exact(x):
    """Exact (erf) GELU, torch's nn.GELU default."""
    return F.gelu(x)


def conv_nhwc(conv: nn.Conv2d, x):
    """Apply ``conv`` to an NHWC tensor; returns NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight, conv.bias, conv.stride,
                 conv.padding, conv.dilation, conv.groups)
    return y.permute(0, 2, 3, 1)


def drop_path(x, rate: float, u):
    """Stochastic depth over the batch (ref: hat_arch.py:46-54; JAX
    ``arch_util.drop_path``): x / keep * floor(keep + u), keep = 1 - rate, u
    the (B,) uniform draws in [0, 1) the caller made."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.floor(keep + u.to(x.device, torch.float32))
    return x / keep * mask.to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))


class DropPathBlock:
    """A block whose branches take drop path at ``drop_path_rate`` (set by
    the block): in training mode at a rate above 0 it takes two uniform
    draws a sample (:func:`run_blocks`) and runs the route JAX's block runs
    there (``deterministic=False``)."""

    def takes_draws(self) -> bool:
        return self.training and self.drop_path_rate > 0


def run_blocks(blocks, x, draws):
    """Each block of ``blocks`` in turn; a block that takes drop-path draws
    (``takes_draws()``) gets the next (2, B) of ``draws``."""
    n = 0
    for blk in blocks:
        if blk.takes_draws():
            x = blk(x, draws[n])
            n += 1
        else:
            x = blk(x)
    return x


class DropPathGroup(nn.Module):
    """A residual group whose ``residual_group.blocks`` may take drop-path
    draws; ``forward(x, draws)`` gets one (2, B) for each block that does
    (:meth:`SRShell.run_layers`)."""

    def draw_count(self) -> int:
        return sum(blk.takes_draws() for blk in self.residual_group.blocks)


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
        elif isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Conv3d)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            nn.init.uniform_(m.weight, -bound, bound, generator=generator)
            if m.bias is not None:
                nn.init.uniform_(m.bias, -bound, bound, generator=generator)
    for m in module.modules():
        if hasattr(m, "seeded_init"):
            m.seeded_init(generator)


def pad_symmetric(x, pad_h: int, pad_w: int):
    """Pad an NHWC tensor at the bottom and the right with its own mirror
    image, the edge row included: numpy's ``symmetric`` mode, which
    ``F.pad`` lacks."""
    for dim, need in ((1, pad_h), (2, pad_w)):
        while need > 0:
            ext = x.flip(dim).narrow(dim, 0, min(need, x.shape[dim]))
            x = torch.cat([x, ext], dim)
            need -= ext.shape[dim]
    return x


class DepthwiseConv(nn.Module):
    """k x k depthwise conv + GELU, under the checkpoints' Sequential name
    (``depthwise_conv.0``)."""

    def __init__(self, hidden: int, kernel_size: int = 5):
        super().__init__()
        self.depthwise_conv = nn.Sequential(
            nn.Conv2d(hidden, hidden, kernel_size, 1, (kernel_size - 1) // 2,
                      groups=hidden), nn.GELU())

    def forward(self, x):
        return gelu_exact(conv_nhwc(self.depthwise_conv[0], x))


class DepthwiseConvFFN(nn.Module):
    """fc1 -> GELU -> (+ k x k depthwise conv, GELU) -> fc2 on NHWC: the
    ConvFFN of SRFormer and ATD."""

    def __init__(self, in_features: int, hidden: int, kernel_size: int = 5):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden)
        self.dwconv = DepthwiseConv(hidden, kernel_size)
        self.fc2 = nn.Linear(hidden, in_features)

    def forward(self, x):
        x = gelu_exact(self.fc1(x))
        return self.fc2(x + self.dwconv(x))


def residual_conv(dim: int, resi_connection: str) -> nn.Module | None:
    """The conv after a stack of blocks, under the checkpoints' names:
    ``1conv`` a 3 x 3 conv, ``3conv`` 3 x 3 to dim / 4, LeakyReLU(0.2),
    1 x 1, LeakyReLU(0.2), 3 x 3 back to dim (``.0``, ``.2``, ``.4``);
    anything else none."""
    if resi_connection == "1conv":
        return nn.Conv2d(dim, dim, 3, 1, 1)
    if resi_connection == "3conv":
        return nn.Sequential(
            nn.Conv2d(dim, dim // 4, 3, 1, 1), nn.LeakyReLU(0.2, True),
            nn.Conv2d(dim // 4, dim // 4, 1, 1, 0), nn.LeakyReLU(0.2, True),
            nn.Conv2d(dim // 4, dim, 3, 1, 1))
    return None


def apply_residual_conv(conv: nn.Module, x):
    """:func:`residual_conv`'s module on an NHWC tensor."""
    if isinstance(conv, nn.Conv2d):
        return conv_nhwc(conv, x)
    y = F.leaky_relu(conv_nhwc(conv[0], x), 0.2)
    y = F.leaky_relu(conv_nhwc(conv[2], y), 0.2)
    return conv_nhwc(conv[4], y)


def upsample_steps(upscale: int) -> list:
    """Pixel-shuffle factors of the ``pixelshuffle`` tail."""
    if upscale & (upscale - 1) == 0:
        return [2] * int(math.log2(upscale))
    if upscale == 3:
        return [3]
    raise ValueError(f"upscale {upscale} unsupported")


class SRShell(nn.Module):
    """What the Swin-family SR networks share around their stack of
    residual groups: shallow conv -> [layers] -> norm, body conv and global
    residual -> reconstruction, under the checkpoints' names. Input and
    output are NHWC. A subclass builds ``layers`` and hands them over.

    ``upsampler``: ``pixelshuffle`` (conv + LeakyReLU, [conv, shuffle]*,
    conv), ``pixelshuffledirect`` (one conv and one shuffle), ``nearest+conv``
    (x4 only: two nearest-neighbour doublings, each followed by a conv and
    LeakyReLU(0.2)) or ``""`` (no upscaling: the input plus a last conv).
    ``resi_connection``: the body conv, ``1conv`` or ``3conv``
    (:func:`residual_conv`). The input is mean-shifted where it has three
    channels, else only scaled by ``img_range``. ``pad_mode``: how ``forward``
    pads the bottom and right of an input that is no window multiple
    (``reflect`` as often as needed, ``symmetric``) before it crops the
    output; None leaves that to the caller.

    Training (``run_layers``): a block that takes drop-path draws gets them
    from the generator passed to ``forward``; with ``use_checkpoint`` each
    residual group runs under ``torch.utils.checkpoint``.

    Weights start at torch's defaults; :func:`init_weights` gives the seeded
    initialisation, a checkpoint gives trained ones.
    """

    # remat each residual group where a gradient is recorded
    use_checkpoint = False

    def __init__(self, layers: Sequence[nn.Module], in_chans: int,
                 embed_dim: int, window_size: int, patch_norm: bool,
                 upscale: int, img_range: float, upsampler: str,
                 resi_connection: str, pad_mode: str | None = None):
        super().__init__()
        if upsampler not in ("pixelshuffle", "pixelshuffledirect",
                             "nearest+conv", ""):
            raise NotImplementedError(f"upsampler {upsampler!r}")
        if upsampler == "nearest+conv" and upscale != 4:
            raise ValueError("the nearest+conv upsampler is x4 only")
        num_feat = 64
        self.img_range = img_range
        self.in_chans = in_chans
        self.upscale = upscale if upsampler else 1
        self.upsampler = upsampler
        self.window_size = window_size
        self.pad_mode = pad_mode
        # the factor of the output crop after a pad
        self.crop_scale = self.upscale
        self.conv_first = nn.Conv2d(in_chans, embed_dim, 3, 1, 1)
        self.patch_embed = PatchEmbedNorm(embed_dim, patch_norm)
        self.layers = nn.ModuleList(layers)
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.conv_after_body = residual_conv(embed_dim, resi_connection)
        if upsampler in ("pixelshuffle", "nearest+conv"):
            self.conv_before_upsample = nn.Sequential(
                nn.Conv2d(embed_dim, num_feat, 3, 1, 1),
                nn.LeakyReLU(inplace=True))
        if upsampler == "pixelshuffle":
            up = []
            for r in upsample_steps(upscale):
                up += [nn.Conv2d(num_feat, r * r * num_feat, 3, 1, 1),
                       nn.PixelShuffle(r)]
            self.upsample = nn.Sequential(*up)
        elif upsampler == "nearest+conv":
            self.conv_up1 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
            self.conv_up2 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
            self.conv_hr = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        elif upsampler == "pixelshuffledirect":
            self.upsample = nn.Sequential(
                nn.Conv2d(embed_dim, upscale * upscale * in_chans, 3, 1, 1),
                nn.PixelShuffle(upscale))
        if upsampler in ("pixelshuffle", "nearest+conv"):
            self.conv_last = nn.Conv2d(num_feat, in_chans, 3, 1, 1)
        elif not upsampler:
            self.conv_last = nn.Conv2d(embed_dim, in_chans, 3, 1, 1)

    def recon(self, f):
        """Reconstruction tail of the upsamplers."""
        y = f
        if self.upsampler in ("pixelshuffle", "nearest+conv"):
            y = F.leaky_relu(conv_nhwc(self.conv_before_upsample[0], f), 0.01)
        if self.upsampler == "nearest+conv":
            for conv in (self.conv_up1, self.conv_up2):
                y = y.repeat_interleave(2, 1).repeat_interleave(2, 2)
                y = F.leaky_relu(conv_nhwc(conv, y), 0.2)
            y = F.leaky_relu(conv_nhwc(self.conv_hr, y), 0.2)
            return conv_nhwc(self.conv_last, y)
        for i in range(0, len(self.upsample), 2):
            conv, shuffle = self.upsample[i], self.upsample[i + 1]
            y = pixel_shuffle(conv_nhwc(conv, y), shuffle.upscale_factor)
        return (conv_nhwc(self.conv_last, y)
                if self.upsampler == "pixelshuffle" else y)

    def reconstruct(self, feat):
        return self.recon(feat)

    def run_layers(self, body, generator: torch.Generator | None = None):
        """The stack of residual groups. The drop-path draws of every block
        that takes them (:class:`DropPathGroup`) are made here, once, from
        ``generator`` on its device (the CPU by default), outside any
        checkpointed region, so that a recompute sees the same."""
        counts = [layer.draw_count() if isinstance(layer, DropPathGroup)
                  else 0 for layer in self.layers]
        draws = [None] * len(counts)
        if sum(counts):
            device = generator.device if generator is not None else "cpu"
            u = torch.rand((sum(counts), 2, body.shape[0]),
                           generator=generator, device=device)
            draws = u.to(body.device).split(counts)
        remat = self.use_checkpoint and torch.is_grad_enabled()
        for layer, d in zip(self.layers, draws):
            args = (body, d) if isinstance(layer, DropPathGroup) else (body,)
            body = (checkpoint(layer, *args, use_reentrant=False) if remat
                    else layer(*args))
        return body

    def _normalize(self, x):
        return (MeanShift.normalize(x, self.img_range) if self.in_chans == 3
                else x * self.img_range)

    def head(self, x):
        """Everything ahead of the residual-group stack: (feat, body) of a
        window-multiple input (the split of ``parallel/pipeline.py``, which
        runs the shape-preserving groups as pipeline stages)."""
        ws = self.window_size
        if x.shape[1] % ws or x.shape[2] % ws:
            raise ValueError(f"{type(self).__name__}.head needs a "
                             f"window-multiple input (window {ws}), got "
                             f"{tuple(x.shape)}; pad as HATModel does")
        feat = conv_nhwc(self.conv_first, self._normalize(x)).contiguous()
        return feat, self.patch_embed(feat)

    def tail(self, body, feat, x=None):
        """Everything after the stack: the norm, the body conv and the
        global residual, the reconstruction. ``x``: the input, which the
        ``""`` upsampler adds back."""
        body = layer_norm(self.norm, body)
        if self.conv_after_body is not None:
            body = apply_residual_conv(self.conv_after_body, body)
        feat = body + feat
        if self.upsampler:
            y = self.reconstruct(feat)
        else:
            y = self._normalize(x) + conv_nhwc(self.conv_last, feat)
        return (MeanShift.denormalize(y, self.img_range) if self.in_chans == 3
                else y / self.img_range)

    def forward(self, x, generator: torch.Generator | None = None):
        """``generator`` goes to :meth:`run_layers`."""
        h, w = x.shape[1], x.shape[2]
        if self.pad_mode is not None:
            ws = self.window_size
            pad_h, pad_w = (ws - h % ws) % ws, (ws - w % ws) % ws
            pad = (pad_symmetric if self.pad_mode == "symmetric"
                   else reflect_pad)
            x = pad(x, pad_h, pad_w)
        feat = conv_nhwc(self.conv_first, self._normalize(x)).contiguous()
        body = self.run_layers(self.patch_embed(feat), generator)
        y = self.tail(body, feat, x)
        if self.pad_mode is not None:
            y = y[:, :h * self.crop_scale, :w * self.crop_scale, :]
        return y


class HATShell(SRShell):
    """The shell of the classic HAT and the fork's HAT: the ``pixelshuffle``
    :class:`SRShell` with the checkpoints' two index buffers and an optional
    streamed reconstruction tail. The caller pads to a window multiple."""

    def __init__(self, layers: Sequence[nn.Module], in_chans: int,
                 embed_dim: int, window_size: int, overlap_ratio: float,
                 patch_norm: bool, upscale: int, img_range: float,
                 upsampler: str, resi_connection: str, stream_tail_rows: int):
        if upsampler != "pixelshuffle":
            raise NotImplementedError("only the 'pixelshuffle' upsampler")
        super().__init__(layers, in_chans, embed_dim, window_size, patch_norm,
                         upscale, img_range, upsampler, resi_connection)
        # >0: run the reconstruction tail over row bands of this height
        # (ops/streamed_tail.py), which bounds its activation peak. Exact.
        self.stream_tail_rows = stream_tail_rows
        # index buffers of the checkpoints, kept so those load strictly;
        # each attention module holds its own copy
        self.register_buffer("relative_position_index_SA", index_buffer(
            relative_position_index_sa(window_size)))
        self.register_buffer("relative_position_index_OCA", index_buffer(
            relative_position_index_oca(window_size, overlap_ratio)))

    def reconstruct(self, feat):
        if self.stream_tail_rows:
            return streamed_rows(self.recon, feat, self.upscale,
                                 self.stream_tail_rows)
        return self.recon(feat)


def _l2n(x):
    return x / (x.norm() + 1e-12)


class StoredSpectralNormConv2d(nn.Module):
    """A conv divided by its spectral norm as ``torch.nn.utils.
    spectral_norm`` computes it in eval mode, in every mode (port of the
    JAX package's ``arch_util.SNConv2d``; DFDNet's and HiFaceGAN's convs).

    It holds ``weight_orig`` (a parameter), ``weight_u`` (out,) and
    ``weight_v`` (in k k,) (buffers), the names of a torch spectral-norm
    checkpoint, and computes sigma = u . (W v) from the stored vectors, with
    no power iteration: u and v take no gradient and an optimizer step
    leaves them as they are, as in JAX. ``torch.nn.utils.spectral_norm``
    power-iterates and stores new vectors in every training-mode forward,
    and would drift from JAX after the first step. The U-Net's
    ``discriminator_arch.SNConv2d`` is flax ``nn.SpectralNorm`` (one power
    iteration a forward from the stored u, v not stored) and is not this.
    NCHW in and out."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 bias: bool = True):
        super().__init__()
        self.out_channels = out_channels
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.weight_orig = nn.Parameter(torch.empty(
            out_channels, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        self.register_buffer("weight_u", torch.zeros(out_channels))
        self.register_buffer("weight_v", torch.zeros(
            in_channels * kernel_size * kernel_size))
        self.seeded_init(None)

    @torch.no_grad()
    def seeded_init(self, generator, iterations: int = 20) -> None:
        """torch's default conv draw (uniform, bound 1 / sqrt(fan_in)), and
        u and v of ``iterations`` power iterations on that weight from a
        random v, so that sigma is its largest singular value, as in a
        trained checkpoint (vectors drawn at random give a sigma near 0)."""
        w = self.weight_orig
        bound = 1.0 / math.sqrt(w[0].numel())
        nn.init.uniform_(w, -bound, bound, generator=generator)
        if self.bias is not None:
            nn.init.uniform_(self.bias, -bound, bound, generator=generator)
        w = w.reshape(self.out_channels, -1)
        v = _l2n(torch.randn(w.shape[1], generator=generator,
                             device=w.device, dtype=w.dtype))
        for _ in range(iterations):
            v = _l2n(w.t() @ _l2n(w @ v))
        self.weight_u.copy_(_l2n(w @ v))
        self.weight_v.copy_(v)

    def sn_weight(self):
        w = self.weight_orig
        sigma = torch.dot(self.weight_u,
                          w.reshape(self.out_channels, -1) @ self.weight_v)
        return w / sigma

    def forward(self, x):
        return F.conv2d(x, self.sn_weight(), self.bias, self.stride,
                        self.padding, self.dilation)
