"""The U-Net discriminator with spectral normalisation (port of
``UNetDiscriminatorSN`` of super_resolution_tpu/models/discriminator_arch.py;
ref: hat/archs/discriminator_arch.py:7-67): conv0, three strided down
convs, three up convs with skip connections, two more convs and a
one-channel head; the inner eight convs spectrally normalised.

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
stored. ``DeepUNetDiscriminatorSN`` and ``VGGStyleDiscriminator`` of the
same JAX module are not ported (ROADMAP.md queue 1).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from super_resolution_tpu_torch.ops.resize import resize_to
from super_resolution_tpu_torch.utils.registry import ARCH_REGISTRY

SN_EPS = 1e-12


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
