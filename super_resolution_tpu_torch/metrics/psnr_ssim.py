"""PSNR / SSIM with MATLAB parity (a copy of the numpy half of
super_resolution_tpu/metrics/psnr_ssim.py), and its batched on-device
half in PyTorch (``calculate_psnr_pt``, ``calculate_ssim_pt``).

Matches the published protocol exactly (ref:
HAT/ESC/basicsr/metrics/psnr_ssim.py — calculate_psnr:12-48,
calculate_ssim:85-128, _ssim:170-198): uint8 [0,255] inputs, optional
crop_border and BT.601 Y-channel, SSIM = 11x11 sigma=1.5 Gaussian in valid
mode averaged per channel.

cv2 is deliberately not used: the Gaussian window and valid-mode filtering
are implemented directly (separable sliding-window contraction) so the
metric stack has zero OpenCV dependency.
"""

from __future__ import annotations

import numpy as np
import torch

from super_resolution_tpu_torch.utils.color import rgb_to_y_pt, to_y_channel
from super_resolution_tpu_torch.utils.registry import METRIC_REGISTRY


def gaussian_kernel_1d(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """Same kernel as cv2.getGaussianKernel(size, sigma) for size > 7."""
    half = (size - 1) / 2.0
    x = np.arange(size, dtype=np.float64) - half
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / k.sum()


def _reorder(img: np.ndarray, input_order: str) -> np.ndarray:
    if input_order not in ("HWC", "CHW"):
        raise ValueError(f"Wrong input_order {input_order}")
    if img.ndim == 2:
        img = img[..., None]
    elif input_order == "CHW":
        img = img.transpose(1, 2, 0)
    return img


def _filter_valid_separable(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Valid-mode 2D correlation with a separable (outer(k,k)) window."""
    n = k.size
    # axis 0
    v = np.lib.stride_tricks.sliding_window_view(img, n, axis=0)
    img = v @ k
    # axis 1
    v = np.lib.stride_tricks.sliding_window_view(img, n, axis=1)
    return v @ k


@METRIC_REGISTRY.register()
def calculate_psnr(img, img2, crop_border, input_order="HWC", test_y_channel=False, **kwargs):
    """PSNR of two [0,255] images; protocol-identical to the reference."""
    assert img.shape == img2.shape, f"Image shapes differ: {img.shape} vs {img2.shape}"
    img = _reorder(np.asarray(img), input_order)
    img2 = _reorder(np.asarray(img2), input_order)
    if crop_border != 0:
        img = img[crop_border:-crop_border, crop_border:-crop_border, ...]
        img2 = img2[crop_border:-crop_border, crop_border:-crop_border, ...]
    if test_y_channel:
        img = to_y_channel(img)
        img2 = to_y_channel(img2)
    img = img.astype(np.float64)
    img2 = img2.astype(np.float64)
    mse = np.mean((img - img2) ** 2)
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(255.0 * 255.0 / mse)


def _ssim_channel(img: np.ndarray, img2: np.ndarray) -> float:
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    k = gaussian_kernel_1d(11, 1.5)
    mu1 = _filter_valid_separable(img, k)
    mu2 = _filter_valid_separable(img2, k)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _filter_valid_separable(img * img, k) - mu1_sq
    sigma2_sq = _filter_valid_separable(img2 * img2, k) - mu2_sq
    sigma12 = _filter_valid_separable(img * img2, k) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return float(ssim_map.mean())


@METRIC_REGISTRY.register()
def calculate_ssim(img, img2, crop_border, input_order="HWC", test_y_channel=False, **kwargs):
    """SSIM of two [0,255] images; protocol-identical to the reference."""
    assert img.shape == img2.shape, f"Image shapes differ: {img.shape} vs {img2.shape}"
    img = _reorder(np.asarray(img), input_order)
    img2 = _reorder(np.asarray(img2), input_order)
    if crop_border != 0:
        img = img[crop_border:-crop_border, crop_border:-crop_border, ...]
        img2 = img2[crop_border:-crop_border, crop_border:-crop_border, ...]
    if test_y_channel:
        img = to_y_channel(img)
        img2 = to_y_channel(img2)
    img = img.astype(np.float64)
    img2 = img2.astype(np.float64)
    ssims = [_ssim_channel(img[..., i], img2[..., i]) for i in range(img.shape[2])]
    return float(np.mean(ssims))


# ---------------------------------------------------------------------------
# batched, on the tensors' device (BasicSR's calculate_psnr_pt / _ssim_pt)
# ---------------------------------------------------------------------------

def _crop_and_y(img, img2, crop_border: int, test_y_channel: bool):
    if crop_border != 0:
        img = img[:, crop_border:-crop_border, crop_border:-crop_border, :]
        img2 = img2[:, crop_border:-crop_border, crop_border:-crop_border, :]
    if test_y_channel:
        img, img2 = rgb_to_y_pt(img), rgb_to_y_pt(img2)
    return img, img2


def calculate_psnr_pt(img, img2, crop_border: int,
                      test_y_channel: bool = False):
    """Batched PSNR of NHWC [0, 1] tensors; returns the (N,) per-image
    values (JAX ``calculate_psnr_jnp``)."""
    img, img2 = _crop_and_y(img, img2, crop_border, test_y_channel)
    d = img.float() - img2.float()
    mse = (d * d).mean(dim=(1, 2, 3))
    return 10.0 * torch.log10(1.0 / (mse + 1e-8))


def calculate_ssim_pt(img, img2, crop_border: int,
                      test_y_channel: bool = False):
    """Batched SSIM of NHWC [0, 1] tensors, the valid-mode 11 x 11
    Gaussian (sigma 1.5) as a depthwise ``F.conv2d``; returns the (N,)
    per-image values averaged over channels (JAX ``calculate_ssim_jnp``,
    which runs an XLA convolution)."""
    import torch.nn.functional as F

    img, img2 = _crop_and_y(img, img2, crop_border, test_y_channel)
    x = img.float().permute(0, 3, 1, 2) * 255.0
    y = img2.float().permute(0, 3, 1, 2) * 255.0
    c = x.shape[1]
    k = torch.as_tensor(gaussian_kernel_1d(11, 1.5), dtype=torch.float32,
                        device=x.device)
    kern = (k[:, None] * k[None, :]).expand(c, 1, 11, 11)

    def blur(t):
        return F.conv2d(t, kern, groups=c)

    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    # the variances around 128: blur(x^2) - mu^2 loses bits to float32
    # cancellation at the [0, 255] scale, and they are shift-invariant
    xs, ys = x - 128.0, y - 128.0
    mu1s, mu2s = blur(xs), blur(ys)
    sigma1_sq = blur(xs * xs) - mu1s * mu1s
    sigma2_sq = blur(ys * ys) - mu2s * mu2s
    sigma12 = blur(xs * ys) - mu1s * mu2s
    mu1, mu2 = mu1s + 128.0, mu2s + 128.0
    cs = (2 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    ssim_map = ((2 * mu1 * mu2 + c1) / (mu1 * mu1 + mu2 * mu2 + c1)) * cs
    return ssim_map.mean(dim=(1, 2, 3))
