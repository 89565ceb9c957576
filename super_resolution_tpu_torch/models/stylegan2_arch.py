"""StyleGAN2 generator and discriminator (port of super_resolution_tpu/
models/stylegan2_arch.py; ref: basicsr/archs/stylegan2_arch.py:12-799).

The networks compute in NCHW. The generator's ``forward`` returns NHWC
images and the discriminator takes them, as the JAX package's do and as
the port's runners feed them. Module names are BasicSR's
(``style_mlp.N``, ``constant_input.weight``, ``style_convs.N.weight`` for
the noise weight, ``style_convs.N.activate.bias``, ``to_rgbs.N``,
``conv_body.N``, ``final_linear.N``), and the stored noises are buffers
``noises.noiseN``: an official ``.pth`` loads strict.

The modulated conv folds the batch into groups (one grouped convolution
for the batch, as the reference does; JAX vmaps a per-sample conv); its
upsampling form is ``conv_transpose2d(stride 2, groups=b)`` followed by
the FIR smoothing of ``ops/upfirdn.py``. Random noise comes from the
``generator`` a forward is given (a ``torch.Generator`` on the output's
device), where JAX draws from its ``noise`` rng stream.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from super_resolution_tpu_torch.ops.upfirdn import (fused_leaky_relu,
                                                    make_resample_kernel,
                                                    upfirdn2d)
from super_resolution_tpu_torch.utils.registry import ARCH_REGISTRY


def stylegan_channels(channel_multiplier: int, narrow: float) -> dict:
    """The feature width at each resolution (ref: stylegan2_arch.py:424)."""
    wide = {"4": 512, "8": 512, "16": 512, "32": 512}
    for res, base in (("64", 256), ("128", 128), ("256", 64), ("512", 32),
                      ("1024", 16)):
        wide[res] = base * channel_multiplier
    return {k: int(v * narrow) for k, v in wide.items()}


def norm_style_code(x):
    return x * torch.rsqrt((x ** 2).mean(dim=1, keepdim=True) + 1e-8)


class NormStyleCode(nn.Module):
    def forward(self, x):
        return norm_style_code(x)


def _randn(generator, shape, like):
    return torch.randn(shape, generator=generator, device=like.device,
                       dtype=like.dtype)


def upfirdn_upsample(x, resample_kernel, factor=2):
    kernel = make_resample_kernel(resample_kernel) * factor ** 2
    pad = kernel.shape[0] - factor
    return upfirdn2d(x, kernel, up=factor,
                     pad=((pad + 1) // 2 + factor - 1, pad // 2))


def upfirdn_smooth(x, resample_kernel, upsample_factor=1,
                   downsample_factor=1, kernel_size=1):
    kernel = make_resample_kernel(resample_kernel)
    if upsample_factor > 1:
        kernel = kernel * upsample_factor ** 2
        pad = (kernel.shape[0] - upsample_factor) - (kernel_size - 1)
        pads = ((pad + 1) // 2 + upsample_factor - 1, pad // 2 + 1)
    elif downsample_factor > 1:
        pad = (kernel.shape[0] - downsample_factor) + (kernel_size - 1)
        pads = ((pad + 1) // 2, pad // 2)
    else:
        raise NotImplementedError
    return upfirdn2d(x, kernel, pad=pads)


class EqualLinear(nn.Module):
    """Equalised linear: weight (O, I) drawn N(0, 1) / lr_mul, scaled by
    lr_mul / sqrt(I) at run time (ref: stylegan2_arch.py:134-175)."""

    def __init__(self, in_channels: int, out_channels: int, bias: bool = True,
                 bias_init_val: float = 0.0, lr_mul: float = 1.0,
                 activation: str | None = None):
        super().__init__()
        self.lr_mul = lr_mul
        self.bias_init_val = bias_init_val
        self.activation = activation
        self.scale = (1.0 / math.sqrt(in_channels)) * lr_mul
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels))
        self.bias = (nn.Parameter(torch.empty(out_channels)) if bias
                     else None)
        self.seeded_init(None)

    @torch.no_grad()
    def seeded_init(self, generator) -> None:
        self.weight.copy_(torch.randn(self.weight.shape, generator=generator)
                          / self.lr_mul)
        if self.bias is not None:
            self.bias.fill_(self.bias_init_val)

    def forward(self, x):
        bias = None if self.bias is None else self.bias * self.lr_mul
        if self.activation == "fused_lrelu":
            return fused_leaky_relu(F.linear(x, self.weight * self.scale),
                                    bias)
        return F.linear(x, self.weight * self.scale, bias)


class ModulatedConv2d(nn.Module):
    """Style-modulated conv, NCHW (ref: stylegan2_arch.py:182-279)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 num_style_feat: int, demodulate: bool = True,
                 sample_mode: str | None = None,
                 resample_kernel: Sequence[int] = (1, 3, 3, 1),
                 eps: float = 1e-8):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size = kernel_size
        self.demodulate = demodulate
        self.sample_mode = sample_mode
        self.resample_kernel = tuple(resample_kernel)
        self.eps = eps
        self.scale = 1.0 / math.sqrt(in_channels * kernel_size ** 2)
        self.modulation = EqualLinear(num_style_feat, in_channels,
                                      bias_init_val=1.0)
        self.weight = nn.Parameter(torch.empty(
            1, out_channels, in_channels, kernel_size, kernel_size))
        self.seeded_init(None)

    @torch.no_grad()
    def seeded_init(self, generator) -> None:
        self.weight.copy_(torch.randn(self.weight.shape, generator=generator))

    def modulated_weight(self, style):
        """(b, O, I, k, k): the weight scaled by the style, demodulated."""
        s = self.modulation(style)
        weight = self.scale * self.weight * s[:, None, :, None, None]
        if self.demodulate:
            demod = torch.rsqrt((weight ** 2).sum(dim=(2, 3, 4)) + self.eps)
            weight = weight * demod[:, :, None, None, None]
        return weight

    def forward(self, x, style):
        b, c, h, w = x.shape
        o, k = self.out_channels, self.kernel_size
        weight = self.modulated_weight(style)
        if self.sample_mode == "upsample":
            wt = weight.transpose(1, 2).reshape(b * c, o, k, k)
            out = F.conv_transpose2d(x.reshape(1, b * c, h, w), wt,
                                     stride=2, groups=b)
            out = out.reshape(b, o, *out.shape[2:])
            return upfirdn_smooth(out, self.resample_kernel, 2, 1, k)
        weight = weight.reshape(b * o, c, k, k)
        if self.sample_mode == "downsample":
            x = upfirdn_smooth(x, self.resample_kernel, 1, 2, k)
            out = F.conv2d(x.reshape(1, b * c, *x.shape[2:]), weight,
                           stride=2, groups=b)
        else:
            out = F.conv2d(x.reshape(1, b * c, h, w), weight, padding=k // 2,
                           groups=b)
        return out.reshape(b, o, *out.shape[2:])


class FusedLeakyReLU(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return fused_leaky_relu(x, self.bias)


class StyleConv(nn.Module):
    """Modulated conv + noise injection (``weight``, 0 at the start) +
    fused activation (ref: stylegan2_arch.py:288-333)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 num_style_feat: int, demodulate: bool = True,
                 sample_mode: str | None = None,
                 resample_kernel: Sequence[int] = (1, 3, 3, 1)):
        super().__init__()
        self.modulated_conv = ModulatedConv2d(
            in_channels, out_channels, kernel_size, num_style_feat,
            demodulate, sample_mode, resample_kernel)
        self.weight = nn.Parameter(torch.zeros(1))
        self.activate = FusedLeakyReLU(out_channels)

    def forward(self, x, style, noise=None, generator=None):
        out = self.modulated_conv(x, style)
        if noise is None:
            b, _, h, w = out.shape
            noise = _randn(generator, (b, 1, h, w), out)
        return self.activate(out + self.weight * noise)


class ToRGB(nn.Module):
    """Features -> RGB, plus the upsampled skip (ref:
    stylegan2_arch.py:336-374)."""

    def __init__(self, in_channels: int, num_style_feat: int,
                 upsample: bool = True,
                 resample_kernel: Sequence[int] = (1, 3, 3, 1)):
        super().__init__()
        self.upsample = upsample
        self.resample_kernel = tuple(resample_kernel)
        self.modulated_conv = ModulatedConv2d(
            in_channels, 3, 1, num_style_feat, demodulate=False)
        self.bias = nn.Parameter(torch.zeros(1, 3, 1, 1))

    def resample_skip(self, skip):
        return upfirdn_upsample(skip, self.resample_kernel)

    def forward(self, x, style, skip=None):
        out = self.modulated_conv(x, style) + self.bias
        if skip is not None:
            if self.upsample:
                skip = self.resample_skip(skip)
            out = out + skip
        return out


class ConstantInput(nn.Module):
    def __init__(self, channels: int, size: int = 4):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1, channels, size, size))
        self.seeded_init(None)

    @torch.no_grad()
    def seeded_init(self, generator) -> None:
        self.weight.copy_(torch.randn(self.weight.shape, generator=generator))

    def forward(self, batch: int):
        return self.weight.repeat(batch, 1, 1, 1)


class NoiseBuffers(nn.Module):
    """The stored noises ``noise0`` .. ``noise{n-1}``, (1, 1, res, res)."""

    def __init__(self, num_layers: int):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            res = 2 ** ((i + 5) // 2)
            self.register_buffer(f"noise{i}", torch.randn(1, 1, res, res))

    @torch.no_grad()
    def seeded_init(self, generator) -> None:
        for i in range(self.num_layers):
            buf = getattr(self, f"noise{i}")
            buf.copy_(torch.randn(buf.shape, generator=generator))

    def as_list(self) -> list:
        return [getattr(self, f"noise{i}") for i in range(self.num_layers)]


class _StyleGeneratorBase(nn.Module):
    """The mapping network, the constant input, the stored noises and
    ``forward``; the subclasses build the synthesis layers."""

    def __init__(self, out_size: int, num_style_feat: int, num_mlp: int,
                 channel_multiplier: int, lr_mlp: float, narrow: float):
        super().__init__()
        self.num_style_feat = num_style_feat
        self.channels = stylegan_channels(channel_multiplier, narrow)
        self.style_mlp = nn.Sequential(NormStyleCode(), *[
            EqualLinear(num_style_feat, num_style_feat, lr_mul=lr_mlp,
                        activation="fused_lrelu") for _ in range(num_mlp)])
        self.constant_input = ConstantInput(self.channels["4"], size=4)
        self.log_size = int(math.log(out_size, 2))
        self.num_layers = (self.log_size - 2) * 2 + 1
        self.num_latent = self.log_size * 2 - 2
        self.noises = NoiseBuffers(self.num_layers)

    def get_latent(self, x):
        return self.style_mlp(x)

    def mean_latent(self, num_latent: int, generator=None):
        z = torch.randn(num_latent, self.num_style_feat, generator=generator,
                        device=self.constant_input.weight.device)
        return self.style_mlp(z).mean(0, keepdim=True)

    def forward(self, styles, input_is_latent: bool = False, noise=None,
                randomize_noise: bool = True, truncation: float = 1.0,
                truncation_latent=None, inject_index=None,
                return_latents: bool = False, generator=None):
        """styles: a list of one or two (B, num_style_feat) codes (with
        ``input_is_latent``, latents; one (B, num_latent, C) tensor is taken
        as it is). Two styles mix at ``inject_index``, which the caller
        draws (as JAX, the network draws no index). noise: a list of
        ``num_layers`` NCHW tensors; without it ``randomize_noise`` draws
        from ``generator``, else the stored noises. Returns (NHWC image,
        the latents or None)."""
        if not input_is_latent:
            styles = [self.style_mlp(s) for s in styles]
        if noise is None:
            noise = ([None] * self.num_layers if randomize_noise
                     else self.noises.as_list())
        if truncation < 1:
            styles = [truncation_latent + truncation * (s - truncation_latent)
                      for s in styles]
        if len(styles) == 1:
            latent = (styles[0] if styles[0].ndim == 3 else
                      styles[0][:, None].repeat(1, self.num_latent, 1))
        elif len(styles) == 2:
            if inject_index is None:
                raise ValueError("two styles mix at an explicit inject_index")
            inject_index = int(inject_index)
            latent = torch.cat([
                styles[0][:, None].repeat(1, inject_index, 1),
                styles[1][:, None].repeat(1, self.num_latent - inject_index,
                                          1)], 1)
        else:
            raise ValueError("one or two styles")

        out = self.constant_input(latent.shape[0])
        out = self.style_conv1(out, latent[:, 0], noise[0], generator)
        skip = self.to_rgb1(out, latent[:, 1])
        i = 1
        for conv1, conv2, noise1, noise2, to_rgb in zip(
                self.style_convs[::2], self.style_convs[1::2], noise[1::2],
                noise[2::2], self.to_rgbs):
            out = conv1(out, latent[:, i], noise1, generator)
            out = conv2(out, latent[:, i + 1], noise2, generator)
            skip = to_rgb(out, latent[:, i + 2], skip)
            i += 2
        image = skip.permute(0, 2, 3, 1)
        return (image, latent) if return_latents else (image, None)


@ARCH_REGISTRY.register()
class StyleGAN2Generator(_StyleGeneratorBase):
    """StyleGAN2 generator (ref: stylegan2_arch.py:394-586)."""

    def __init__(self, out_size: int, num_style_feat: int = 512,
                 num_mlp: int = 8, channel_multiplier: int = 2,
                 resample_kernel: Sequence[int] = (1, 3, 3, 1),
                 lr_mlp: float = 0.01, narrow: float = 1.0):
        super().__init__(out_size, num_style_feat, num_mlp,
                         channel_multiplier, lr_mlp, narrow)
        ch = self.channels
        self.style_conv1 = StyleConv(ch["4"], ch["4"], 3, num_style_feat,
                                     resample_kernel=resample_kernel)
        self.to_rgb1 = ToRGB(ch["4"], num_style_feat, upsample=False,
                             resample_kernel=resample_kernel)
        self.style_convs = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        in_channels = ch["4"]
        for i in range(3, self.log_size + 1):
            out_channels = ch[f"{2 ** i}"]
            self.style_convs.append(StyleConv(
                in_channels, out_channels, 3, num_style_feat,
                sample_mode="upsample", resample_kernel=resample_kernel))
            self.style_convs.append(StyleConv(
                out_channels, out_channels, 3, num_style_feat,
                resample_kernel=resample_kernel))
            self.to_rgbs.append(ToRGB(out_channels, num_style_feat,
                                      resample_kernel=resample_kernel))
            in_channels = out_channels


class EqualConv2d(nn.Module):
    """Equalised conv: weight (O, I, k, k) drawn N(0, 1), scaled by
    1 / sqrt(I k k) at run time (ref: stylegan2_arch.py:605-644)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 bias_init_val: float = 0.0):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.bias_init_val = bias_init_val
        self.scale = 1.0 / math.sqrt(in_channels * kernel_size ** 2)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        self.seeded_init(None)

    @torch.no_grad()
    def seeded_init(self, generator) -> None:
        self.weight.copy_(torch.randn(self.weight.shape, generator=generator))
        if self.bias is not None:
            self.bias.fill_(self.bias_init_val)

    def forward(self, x):
        return F.conv2d(x, self.weight * self.scale, self.bias,
                        stride=self.stride, padding=self.padding)


class ScaledLeakyReLU(nn.Module):
    def forward(self, x):
        return F.leaky_relu(x, 0.2) * math.sqrt(2)


class UpFirDnSmooth(nn.Module):
    def __init__(self, resample_kernel, downsample_factor: int,
                 kernel_size: int):
        super().__init__()
        self.resample_kernel = tuple(resample_kernel)
        self.factor, self.kernel_size = downsample_factor, kernel_size

    def forward(self, x):
        return upfirdn_smooth(x, self.resample_kernel, 1, self.factor,
                              self.kernel_size)


class ConvLayer(nn.Sequential):
    """[smooth] + equal conv + [activation] under BasicSR's Sequential
    indices (ref: stylegan2_arch.py:654-701)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 downsample: bool = False,
                 resample_kernel: Sequence[int] = (1, 3, 3, 1),
                 bias: bool = True, activate: bool = True):
        layers = []
        if downsample:
            layers.append(UpFirDnSmooth(resample_kernel, 2, kernel_size))
        layers.append(EqualConv2d(
            in_channels, out_channels, kernel_size,
            stride=2 if downsample else 1,
            padding=0 if downsample else kernel_size // 2,
            bias=bias and not activate))
        if activate:
            layers.append(FusedLeakyReLU(out_channels) if bias
                          else ScaledLeakyReLU())
        super().__init__(*layers)


class ResBlock(nn.Module):
    """Discriminator residual block (ref: stylegan2_arch.py:704-730)."""

    def __init__(self, in_channels: int, out_channels: int,
                 resample_kernel: Sequence[int] = (1, 3, 3, 1)):
        super().__init__()
        self.conv1 = ConvLayer(in_channels, in_channels, 3)
        self.conv2 = ConvLayer(in_channels, out_channels, 3, downsample=True,
                               resample_kernel=resample_kernel)
        self.skip = ConvLayer(in_channels, out_channels, 1, downsample=True,
                              resample_kernel=resample_kernel, bias=False,
                              activate=False)

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        return (out + self.skip(x)) / math.sqrt(2)


@ARCH_REGISTRY.register()
class StyleGAN2Discriminator(nn.Module):
    """StyleGAN2 discriminator (ref: stylegan2_arch.py:733-799): NHWC RGB
    -> (B, 1) logits."""

    def __init__(self, out_size: int, channel_multiplier: int = 2,
                 resample_kernel: Sequence[int] = (1, 3, 3, 1),
                 stddev_group: int = 4, narrow: float = 1.0):
        super().__init__()
        ch = stylegan_channels(channel_multiplier, narrow)
        log_size = int(math.log(out_size, 2))
        body = [ConvLayer(3, ch[f"{out_size}"], 1)]
        in_channels = ch[f"{out_size}"]
        for i in range(log_size, 2, -1):
            out_channels = ch[f"{2 ** (i - 1)}"]
            body.append(ResBlock(in_channels, out_channels, resample_kernel))
            in_channels = out_channels
        self.conv_body = nn.Sequential(*body)
        self.final_conv = ConvLayer(in_channels + 1, ch["4"], 3)
        self.final_linear = nn.Sequential(
            EqualLinear(ch["4"] * 4 * 4, ch["4"], activation="fused_lrelu"),
            EqualLinear(ch["4"], 1))
        self.stddev_group = stddev_group

    def forward(self, x):
        out = self.conv_body(x.permute(0, 3, 1, 2))
        b, c, h, w = out.shape
        group = min(b, self.stddev_group)
        stddev = out.reshape(group, -1, 1, c, h, w)
        stddev = torch.sqrt(stddev.var(0, unbiased=False) + 1e-8)
        stddev = stddev.mean(dim=(2, 3, 4), keepdim=True).squeeze(2)
        out = torch.cat([out, stddev.repeat(group, 1, h, w)], 1)
        out = self.final_conv(out)
        return self.final_linear(out.reshape(b, -1))
