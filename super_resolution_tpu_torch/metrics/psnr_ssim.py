"""PSNR / SSIM with MATLAB parity (a copy of the numpy half of
super_resolution_tpu/metrics/psnr_ssim.py).

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

from super_resolution_tpu_torch.utils.color import to_y_channel
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
