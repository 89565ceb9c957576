"""upfirdn2d and the fused bias + leaky ReLU of StyleGAN2, NCHW (port of
super_resolution_tpu/ops/upfirdn.py; ref: basicsr/ops/upfirdn2d,
basicsr/ops/fused_act).

The reference ships both as CUDA extensions; the JAX package made them
plain XLA convolutions, and no TPU kernel lies on them. Here they are plain
PyTorch on the card too: upfirdn2d is a zero-insertion upsample, a pad and
one depthwise ``F.conv2d`` whose stride is the downsampling factor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def upfirdn2d(x, kernel, up: int = 1, down: int = 1, pad=(0, 0)):
    """Upsample by zero insertion -> pad -> FIR filter -> downsample.

    x: (B, C, H, W); kernel: (kh, kw), applied as a true convolution (the
    reference correlates with the flipped kernel). ``pad`` (pad0, pad1) is
    added before and after both spatial dims of the upsampled image, whose
    size is H * up: the up - 1 zeros after the last sample count, as in the
    reference (the JAX package folds them into its tail pad).
    """
    b, c, h, w = x.shape
    if up > 1:
        z = x.new_zeros(b, c, h * up, w * up)
        z[:, :, ::up, ::up] = x
        x = z
    pad0, pad1 = pad
    x = F.pad(x, (pad0, pad1, pad0, pad1))
    k = torch.flip(torch.as_tensor(kernel, dtype=x.dtype, device=x.device),
                   (0, 1))
    weight = k[None, None].expand(c, 1, *k.shape)
    return F.conv2d(x, weight, stride=down, groups=c)


def fused_leaky_relu(x, bias=None, negative_slope: float = 0.2,
                     scale: float = 2 ** 0.5):
    """(x + bias on the channel dim 1) -> leaky ReLU -> * scale."""
    if bias is not None:
        x = x + bias.reshape((1, -1) + (1,) * (x.ndim - 2))
    return F.leaky_relu(x, negative_slope) * scale


def make_resample_kernel(k) -> torch.Tensor:
    """A 1-D list -> the normalised 2-D kernel (outer product)."""
    k = torch.as_tensor(k, dtype=torch.float32)
    if k.ndim == 1:
        k = k[None, :] * k[:, None]
    return k / k.sum()
