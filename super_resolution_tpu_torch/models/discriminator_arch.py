"""The discriminators (port of super_resolution_tpu/models/
discriminator_arch.py): the U-Net with spectral normalisation (ref:
hat/archs/discriminator_arch.py:7-67), its deeper variant with global
self-attention at the two innermost levels (ref: esc/archs/
discriminator_arch.py:48-117) and the VGG-style discriminator of SRGAN and
ESRGAN (ref: basicsr/archs/discriminator_arch.py:9-88). All take NHWC RGB.

The spectral norm is flax's ``nn.SpectralNorm``, which the JAX package
uses, not ``torch.nn.utils.spectral_norm``:

- every forward runs one power iteration from the stored ``u``, also where
  it does not store the result;
- v = l2n(W^T u), u' = l2n(W v) with l2n(x) = x / sqrt(|x|^2 + 1e-12),
  on W as (out, in kh kw); sigma = u'^T W v with u' and v constant, so
  the gradient reaches W through sigma; the conv runs on W / sigma;
- ``u`` (length out) and ``sigma`` are stored only where the call asks
  for it (``update_sn_stats``).

Flax flattens the kernel as (kh kw in, out), torch as (out, in kh kw):
sigma and ``u`` are the same in both, only v's order differs, and v is not
stored.

The VGG-style discriminator's BatchNorms run on their stored statistics in
training too (:class:`FrozenBatchNorm`, JAX ``arch_util.FrozenBatchNorm``),
not torch's training-mode batch statistics; its ``update_sn_stats`` is
taken for the GAN runner's sake and does nothing (no spectral norm there).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from super_resolution_tpu_torch.ops.resize import resize_to
from super_resolution_tpu_torch.utils.registry import ARCH_REGISTRY

SN_EPS = 1e-12
# the dtype the deep U-Net's self-attention rounds q, k, v and the
# probabilities to (the reference's flash kernel takes bf16)
SA_DTYPE = torch.bfloat16


def _l2_normalize(x):
    return x * torch.rsqrt((x * x).sum() + SN_EPS)


class SNConv2d(nn.Conv2d):
    """A conv whose weight is divided by its spectral norm's estimate (the
    module docstring); buffers ``weight_u`` (out,) and ``weight_sigma``."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # drawn by seeded_init (or loaded); 0 until then
        self.register_buffer("weight_u", torch.zeros(self.out_channels))
        self.register_buffer("weight_sigma", torch.ones(()))

    def seeded_init(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight_u.copy_(torch.randn(self.out_channels,
                                            generator=generator))
            self.weight_sigma.fill_(1.0)

    def forward(self, x, update_stats: bool = False):
        w = self.weight.reshape(self.out_channels, -1)
        with torch.no_grad():
            v = _l2_normalize(w.t() @ self.weight_u)
            u = _l2_normalize(w @ v)
        sigma = torch.dot(u, w @ v)
        if update_stats:
            with torch.no_grad():
                self.weight_u.copy_(u)
                self.weight_sigma.copy_(sigma)
        scale = torch.where(sigma != 0, sigma, torch.ones_like(sigma))
        return F.conv2d(x, self.weight / scale, self.bias, self.stride,
                        self.padding)


def _upx2(x):
    """x2 bilinear on NCHW, through the NHWC ``resize_to``."""
    y = resize_to(x.permute(0, 2, 3, 1), x.shape[2] * 2, x.shape[3] * 2,
                  "bilinear")
    return y.permute(0, 3, 1, 2)


@ARCH_REGISTRY.register()
class UNetDiscriminatorSN(nn.Module):
    """``forward(x, update_sn_stats=False)``: NHWC RGB -> (B, H, W, 1)
    logits."""

    def __init__(self, num_in_ch: int = 3, num_feat: int = 64,
                 skip_connection: bool = True):
        super().__init__()
        nf = num_feat
        self.skip_connection = skip_connection
        self.conv0 = nn.Conv2d(num_in_ch, nf, 3, 1, 1)
        self.conv1 = SNConv2d(nf, nf * 2, 4, 2, 1)
        self.conv2 = SNConv2d(nf * 2, nf * 4, 4, 2, 1)
        self.conv3 = SNConv2d(nf * 4, nf * 8, 4, 2, 1)
        self.conv4 = SNConv2d(nf * 8, nf * 4, 3, 1, 1)
        self.conv5 = SNConv2d(nf * 4, nf * 2, 3, 1, 1)
        self.conv6 = SNConv2d(nf * 2, nf, 3, 1, 1)
        self.conv7 = SNConv2d(nf, nf, 3, 1, 1)
        self.conv8 = SNConv2d(nf, nf, 3, 1, 1)
        self.conv9 = nn.Conv2d(nf, 1, 3, 1, 1)

    def forward(self, x, update_sn_stats: bool = False):
        def sn(conv, v):
            return F.leaky_relu(conv(v, update_sn_stats), 0.2)

        x0 = F.leaky_relu(self.conv0(x.permute(0, 3, 1, 2)), 0.2)
        x1 = sn(self.conv1, x0)
        x2 = sn(self.conv2, x1)
        x3 = sn(self.conv3, x2)
        x4 = sn(self.conv4, _upx2(x3))
        if self.skip_connection:
            x4 = x4 + x2
        x5 = sn(self.conv5, _upx2(x4))
        if self.skip_connection:
            x5 = x5 + x1
        x6 = sn(self.conv6, _upx2(x5))
        if self.skip_connection:
            x6 = x6 + x0
        out = sn(self.conv7, x6)
        out = sn(self.conv8, out)
        return self.conv9(out).permute(0, 2, 3, 1)


class _SelfAttention(nn.Module):
    """Global self-attention over all H * W tokens, no positional encoding
    (ref: esc/archs/discriminator_arch.py:14-45): a 1 x 1 qkv conv, q, k, v
    and the probabilities rounded to ``SA_DTYPE`` as the reference's flash
    kernel takes them (the scores' softmax in float32), then a spectrally
    normalised 1 x 1 conv. NCHW in and out."""

    def __init__(self, dim: int, n_heads: int = 8):
        super().__init__()
        self.n_heads = n_heads
        self.to_qkv = nn.Conv2d(dim, dim * 3, 1, bias=False)
        self.to_out = SNConv2d(dim, dim, 1)

    def forward(self, x, update_stats: bool = False):
        b, c, h, w = x.shape
        ch = c // self.n_heads
        qkv = F.conv2d(x, self.to_qkv.weight).permute(0, 2, 3, 1)
        # channels in the order of the reference's 'b (qkv heads c) h w'
        qkv = qkv.reshape(b, h * w, 3, self.n_heads, ch)
        q, k, v = (qkv[:, :, i].transpose(1, 2).to(SA_DTYPE)
                   for i in range(3))
        scale = torch.tensor(ch ** -0.5, dtype=SA_DTYPE)
        attn = torch.softmax((q @ k.transpose(-1, -2) * scale).float(), -1)
        out = (attn.to(SA_DTYPE) @ v).to(x.dtype)
        out = out.transpose(1, 2).reshape(b, h, w, c).permute(0, 3, 1, 2)
        return self.to_out(out, update_stats)


@ARCH_REGISTRY.register()
class DeepUNetDiscriminatorSN(nn.Module):
    """``forward(x, update_sn_stats=False)``: NHWC RGB -> (B, H, W, 1)
    logits. Against :class:`UNetDiscriminatorSN`: bias-free spectrally
    normalised convs, a residual self-attention on the innermost feature,
    the first skip through a second self-attention (JAX
    ``DeepUNetDiscriminatorSN``)."""

    def __init__(self, num_in_ch: int = 3, num_feat: int = 64,
                 skip_connection: bool = True):
        super().__init__()
        nf = num_feat
        self.skip_connection = skip_connection
        self.conv0 = nn.Conv2d(num_in_ch, nf, 3, 1, 1)
        for name, cin, cout, k, s in (
                ("conv1", nf, nf * 2, 4, 2), ("conv2", nf * 2, nf * 4, 4, 2),
                ("conv3", nf * 4, nf * 8, 4, 2),
                ("conv4", nf * 8, nf * 4, 3, 1),
                ("conv5", nf * 4, nf * 2, 3, 1),
                ("conv6", nf * 2, nf, 3, 1), ("conv7", nf, nf, 3, 1),
                ("conv8", nf, nf, 3, 1)):
            setattr(self, name, SNConv2d(cin, cout, k, s, (k - 1) // 2,
                                         bias=False))
        self.sa2 = _SelfAttention(nf * 8, 8)
        if skip_connection:
            self.sa1 = _SelfAttention(nf * 4, 4)
        self.conv9 = nn.Conv2d(nf, 1, 3, 1, 1)

    def forward(self, x, update_sn_stats: bool = False):
        def sn(conv, v):
            return F.leaky_relu(conv(v, update_sn_stats), 0.2)

        x0 = F.leaky_relu(self.conv0(x.permute(0, 3, 1, 2)), 0.2)
        x1 = sn(self.conv1, x0)
        x2 = sn(self.conv2, x1)
        x3 = sn(self.conv3, x2)
        x3 = x3 + self.sa2(x3, update_sn_stats)
        x4 = sn(self.conv4, _upx2(x3))
        if self.skip_connection:
            x4 = x4 + self.sa1(x2, update_sn_stats)
        x5 = sn(self.conv5, _upx2(x4))
        if self.skip_connection:
            x5 = x5 + x1
        x6 = sn(self.conv6, _upx2(x5))
        if self.skip_connection:
            x6 = x6 + x0
        out = sn(self.conv7, x6)
        out = sn(self.conv8, out)
        return self.conv9(out).permute(0, 2, 3, 1)


class FrozenBatchNorm(nn.Module):
    """BatchNorm on its stored statistics, in every mode: (x - running_mean)
    / sqrt(running_var + eps) * weight + bias over the channels of x (axis
    ``channel_dim``: 1 for NCHW, -1 for the video networks' NHWC / NDHWC),
    under ``nn.BatchNorm2d``'s names (``num_batches_tracked`` too, so its
    checkpoints load strict). The statistics are buffers: nothing trains or
    updates them (JAX ``arch_util.FrozenBatchNorm``)."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 channel_dim: int = 1):
        super().__init__()
        self.eps = eps
        self.channel_dim = channel_dim
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x):
        shape = [1] * x.ndim
        shape[self.channel_dim] = -1

        def col(t):
            return t.reshape(shape)
        return ((x - col(self.running_mean))
                * col(torch.rsqrt(self.running_var + self.eps))
                * col(self.weight) + col(self.bias))


@ARCH_REGISTRY.register()
class VGGStyleDiscriminator(nn.Module):
    """``forward(x, update_sn_stats=False)``: NHWC RGB of ``input_size``
    (128 or 256) a side -> (B, 1) logits. A 3 x 3 conv and a 4 x 4 stride-2
    conv a stage, each but the first followed by a :class:`FrozenBatchNorm`,
    LeakyReLU(0.2) after each; then two linear layers on the NCHW-flattened
    4 x 4 feature."""

    def __init__(self, num_in_ch: int = 3, num_feat: int = 64,
                 input_size: int = 128):
        super().__init__()
        if input_size not in (128, 256):
            raise ValueError(f"input_size must be 128 or 256, got "
                             f"{input_size}")
        nf = num_feat
        self.input_size = input_size
        self.conv0_0 = nn.Conv2d(num_in_ch, nf, 3, 1, 1)
        self.conv0_1 = nn.Conv2d(nf, nf, 4, 2, 1, bias=False)
        self.bn0_1 = FrozenBatchNorm(nf)
        widths = [nf, nf * 2, nf * 4, nf * 8, nf * 8] + (
            [nf * 8] if input_size == 256 else [])
        self.stages = len(widths) - 1
        for i in range(1, len(widths)):
            cin, cout = widths[i - 1], widths[i]
            setattr(self, f"conv{i}_0", nn.Conv2d(cin, cout, 3, 1, 1,
                                                  bias=False))
            setattr(self, f"bn{i}_0", FrozenBatchNorm(cout))
            setattr(self, f"conv{i}_1", nn.Conv2d(cout, cout, 4, 2, 1,
                                                  bias=False))
            setattr(self, f"bn{i}_1", FrozenBatchNorm(cout))
        self.linear1 = nn.Linear(nf * 8 * 4 * 4, 100)
        self.linear2 = nn.Linear(100, 1)

    def forward(self, x, update_sn_stats: bool = False):
        if x.shape[1] != self.input_size or x.shape[2] != self.input_size:
            raise ValueError(f"input must be {self.input_size} x "
                             f"{self.input_size}, got {tuple(x.shape)}")
        feat = F.leaky_relu(self.conv0_0(x.permute(0, 3, 1, 2)), 0.2)
        feat = F.leaky_relu(self.bn0_1(self.conv0_1(feat)), 0.2)
        for i in range(1, self.stages + 1):
            for j in (0, 1):
                conv = getattr(self, f"conv{i}_{j}")
                feat = F.leaky_relu(getattr(self, f"bn{i}_{j}")(conv(feat)),
                                    0.2)
        feat = F.leaky_relu(self.linear1(feat.flatten(1)), 0.2)
        return self.linear2(feat)
