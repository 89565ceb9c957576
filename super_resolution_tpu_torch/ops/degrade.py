"""Degradation ops for real-world SR training, on NHWC tensors on any device
(port of super_resolution_tpu/ops/degrade.py; ref: basicsr/utils/
img_process_util.py filter2D :7, USMSharp :63; basicsr/data/degradations.py
noise ops :496-734): per-sample blur, Gaussian and Poisson noise and USM
sharpening. The resize of the same JAX module is ``ops/resize.py``.

The noise is drawn from the ``torch.Generator`` the caller passes, which
lives on the image's device. It has the distribution of the JAX package's
``jax.random`` draws, not its numbers (ROADMAP.md queue 3). The Poisson
noise keeps JAX's approximation of the reference's shot-noise levels: 1024
levels, where the reference takes 10^ceil(log10(#unique values)).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# the Poisson noise's levels (the JAX package's constant)
POISSON_LEVELS = 1024.0
GRAY_WEIGHTS = (0.299, 0.587, 0.114)


def filter2d_batch(img, kernels):
    """Each sample of ``img`` (B, H, W, C) cross-correlated on every channel
    with its kernel of ``kernels`` (B, k, k), or with the one kernel of a
    (1, k, k), after reflect padding by k // 2 (ref: filter2D). Returns
    (B, H, W, C)."""
    b, h, w, c = img.shape
    k = kernels.shape[-1]
    if k % 2 != 1:
        raise ValueError("Wrong kernel size")
    pad = k // 2
    x = F.pad(img.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="reflect")
    kernels = kernels.to(img.dtype)
    if kernels.shape[0] == 1:
        weight = kernels.expand(c, k, k).unsqueeze(1)
        out = F.conv2d(x, weight, groups=c)
    else:
        weight = kernels[:, None].expand(b, c, k, k).reshape(b * c, 1, k, k)
        out = F.conv2d(x.reshape(1, b * c, h + 2 * pad, w + 2 * pad), weight,
                       groups=b * c).reshape(b, c, h, w)
    return out.permute(0, 2, 3, 1)


def _uniform(shape, lo: float, hi: float, like, generator):
    u = torch.rand(shape, generator=generator, device=like.device,
                   dtype=like.dtype)
    return lo + u * (hi - lo)


def random_gaussian_noise(img, sigma_range=(0, 10), gray_prob=0.0,
                          generator=None):
    """Gaussian noise of a per-sample sigma in ``sigma_range`` (on the 255
    scale); with probability ``gray_prob`` a sample's noise is one plane
    for the three channels (ref: degradations.py:540-556)."""
    b = img.shape[0]
    sigma = _uniform((b, 1, 1, 1), sigma_range[0], sigma_range[1], img,
                     generator) / 255.0
    noise = torch.randn(img.shape, generator=generator, device=img.device,
                        dtype=img.dtype) * sigma
    gray_noise = torch.randn(img.shape[:3] + (1,), generator=generator,
                             device=img.device, dtype=img.dtype) * sigma
    is_gray = _uniform((b, 1, 1, 1), 0.0, 1.0, img, generator) < gray_prob
    return torch.where(is_gray, gray_noise, noise)


def add_gaussian_noise(img, sigma_range=(0, 10), gray_prob=0.0, clip=True,
                       rounds=False, generator=None):
    out = img + random_gaussian_noise(img, sigma_range, gray_prob, generator)
    return _clip_round(out, clip, rounds)


def _shot(x, generator):
    x = torch.clamp(torch.round(x * 255.0), 0, 255) / 255.0
    noisy = torch.poisson(x * POISSON_LEVELS, generator=generator)
    return noisy / POISSON_LEVELS - x


def random_poisson_noise(img, scale_range=(0, 1.0), gray_prob=0.0,
                         generator=None):
    """Shot noise of a per-sample scale in ``scale_range``, on the image
    rounded to 256 levels, with :data:`POISSON_LEVELS` counts for 1.0; with
    probability ``gray_prob`` from the luma plane alone (ref:
    degradations.py:613-658)."""
    b = img.shape[0]
    scale = _uniform((b, 1, 1, 1), scale_range[0], scale_range[1], img,
                     generator)
    noise = _shot(img, generator)
    weights = torch.tensor(GRAY_WEIGHTS, dtype=img.dtype, device=img.device)
    gray = (img * weights).mean(dim=-1, keepdim=True)
    gray_noise = _shot(gray, generator)
    is_gray = _uniform((b, 1, 1, 1), 0.0, 1.0, img, generator) < gray_prob
    return torch.where(is_gray, gray_noise, noise) * scale


def add_poisson_noise(img, scale_range=(0, 1.0), gray_prob=0.0, clip=True,
                      rounds=False, generator=None):
    out = img + random_poisson_noise(img, scale_range, gray_prob, generator)
    return _clip_round(out, clip, rounds)


def _clip_round(out, clip: bool, rounds: bool):
    if clip and rounds:
        return torch.clamp(torch.round(out * 255.0), 0, 255) / 255.0
    if clip:
        return torch.clamp(out, 0, 1)
    if rounds:
        return torch.round(out * 255.0) / 255.0
    return out


def usm_gaussian_kernel(radius: int = 50, sigma: float = 0) -> np.ndarray:
    """The separable Gaussian of ``cv2.getGaussianKernel`` as a 2-D float32
    kernel (sigma 0 derives sigma from the size; ref: img_process_util.py
    USMSharp.__init__)."""
    if radius % 2 == 0:
        radius += 1
    if sigma <= 0:
        sigma = 0.3 * ((radius - 1) * 0.5 - 1) + 0.8
    x = np.arange(radius, dtype=np.float64) - (radius - 1) / 2.0
    k = np.exp(-(x * x) / (2 * sigma * sigma))
    k = (k / k.sum()).astype(np.float32)
    return np.outer(k, k)


def usm_sharp(img, kernel, weight: float = 0.5, threshold: float = 10.0):
    """Unsharp masking with a soft threshold mask (ref: img_process_util.py
    :63-85): sharp = clip(I + w (I - blur)), out = m sharp + (1 - m) I with
    m the blurred mask of |I - blur| * 255 > threshold. ``kernel``: (k, k)."""
    kern = torch.as_tensor(kernel, device=img.device)[None]
    blur = filter2d_batch(img, kern)
    residual = img - blur
    mask = (residual.abs() * 255.0 > threshold).to(img.dtype)
    soft_mask = filter2d_batch(mask, kern)
    sharp = torch.clamp(img + weight * residual, 0, 1)
    return soft_mask * sharp + (1 - soft_mask) * img
