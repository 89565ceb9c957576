"""Blur-kernel synthesis for real-world degradation, on the host in numpy
(a copy of super_resolution_tpu/data/degradations.py, which imports no JAX;
ref: basicsr/data/degradations.py:88-414): bivariate (an)isotropic
Gaussian, generalized Gaussian, plateau, the mixed random choice among them
and the circular sinc low-pass kernel. They run per item in the data loader
(21 x 21 arrays); their application runs on the device
(ops/degrade.py::filter2d_batch).

Every sampler takes an explicit ``rng`` (a numpy Generator), so that one
state gives the JAX package's kernel exactly.
"""

from __future__ import annotations

import math

import numpy as np
from scipy import special


def sigma_matrix2(sig_x: float, sig_y: float, theta: float) -> np.ndarray:
    """Rotated 2x2 covariance matrix."""
    d = np.array([[sig_x ** 2, 0], [0, sig_y ** 2]])
    u = np.array([[np.cos(theta), -np.sin(theta)],
                  [np.sin(theta), np.cos(theta)]])
    return u @ d @ u.T


def mesh_grid(kernel_size: int):
    """Zero-centered coordinate grid, shape (K, K, 2)."""
    ax = np.arange(-kernel_size // 2 + 1.0, kernel_size // 2 + 1.0)
    xx, yy = np.meshgrid(ax, ax)
    return np.stack([xx, yy], axis=-1), xx, yy


def _mahalanobis_sq(sigma_matrix: np.ndarray, grid: np.ndarray) -> np.ndarray:
    inv = np.linalg.inv(sigma_matrix)
    return np.sum((grid @ inv) * grid, axis=2)


def bivariate_gaussian(kernel_size: int, sig_x: float, sig_y: float = None,
                       theta: float = 0.0, grid=None,
                       isotropic: bool = True) -> np.ndarray:
    """Normalized bivariate Gaussian kernel."""
    if grid is None:
        grid, _, _ = mesh_grid(kernel_size)
    if isotropic:
        sigma = np.array([[sig_x ** 2, 0], [0, sig_x ** 2]])
    else:
        sigma = sigma_matrix2(sig_x, sig_y, theta)
    kernel = np.exp(-0.5 * _mahalanobis_sq(sigma, grid))
    return kernel / kernel.sum()


def bivariate_generalized_gaussian(kernel_size: int, sig_x: float,
                                   sig_y: float = None, theta: float = 0.0,
                                   beta: float = 1.0, grid=None,
                                   isotropic: bool = True) -> np.ndarray:
    """exp(-0.5 * (x^T S^-1 x)^beta) — heavier/lighter tails than Gaussian."""
    if grid is None:
        grid, _, _ = mesh_grid(kernel_size)
    if isotropic:
        sigma = np.array([[sig_x ** 2, 0], [0, sig_x ** 2]])
    else:
        sigma = sigma_matrix2(sig_x, sig_y, theta)
    kernel = np.exp(-0.5 * np.power(_mahalanobis_sq(sigma, grid), beta))
    return kernel / kernel.sum()


def bivariate_plateau(kernel_size: int, sig_x: float, sig_y: float = None,
                      theta: float = 0.0, beta: float = 1.0, grid=None,
                      isotropic: bool = True) -> np.ndarray:
    """1 / (1 + (x^T S^-1 x)^beta) — flat-topped plateau kernel."""
    if grid is None:
        grid, _, _ = mesh_grid(kernel_size)
    if isotropic:
        sigma = np.array([[sig_x ** 2, 0], [0, sig_x ** 2]])
    else:
        sigma = sigma_matrix2(sig_x, sig_y, theta)
    kernel = 1.0 / (np.power(_mahalanobis_sq(sigma, grid), beta) + 1)
    return kernel / kernel.sum()


def _sample_aniso(rng, sigma_x_range, sigma_y_range, rotation_range, isotropic):
    sigma_x = rng.uniform(*sigma_x_range)
    if isotropic:
        return sigma_x, sigma_x, 0.0
    sigma_y = rng.uniform(*sigma_y_range)
    rotation = rng.uniform(*rotation_range)
    return sigma_x, sigma_y, rotation


def _apply_kernel_noise(kernel, rng, noise_range):
    if noise_range is not None:
        assert noise_range[0] < noise_range[1]
        kernel = kernel * rng.uniform(noise_range[0], noise_range[1],
                                      size=kernel.shape)
    return kernel / kernel.sum()


def random_bivariate_gaussian(kernel_size, sigma_x_range, sigma_y_range,
                              rotation_range, noise_range=None,
                              isotropic=True, rng=None):
    rng = rng or np.random.default_rng()
    sx, sy, rot = _sample_aniso(rng, sigma_x_range, sigma_y_range,
                                rotation_range, isotropic)
    k = bivariate_gaussian(kernel_size, sx, sy, rot, isotropic=isotropic)
    return _apply_kernel_noise(k, rng, noise_range)


def random_bivariate_generalized_gaussian(kernel_size, sigma_x_range,
                                          sigma_y_range, rotation_range,
                                          beta_range, noise_range=None,
                                          isotropic=True, rng=None):
    rng = rng or np.random.default_rng()
    sx, sy, rot = _sample_aniso(rng, sigma_x_range, sigma_y_range,
                                rotation_range, isotropic)
    # beta sampled below/above 1 with equal probability (reference behavior)
    if rng.uniform() < 0.5:
        beta = rng.uniform(beta_range[0], 1)
    else:
        beta = rng.uniform(1, beta_range[1])
    k = bivariate_generalized_gaussian(kernel_size, sx, sy, rot, beta,
                                       isotropic=isotropic)
    return _apply_kernel_noise(k, rng, noise_range)


def random_bivariate_plateau(kernel_size, sigma_x_range, sigma_y_range,
                             rotation_range, beta_range, noise_range=None,
                             isotropic=True, rng=None):
    rng = rng or np.random.default_rng()
    sx, sy, rot = _sample_aniso(rng, sigma_x_range, sigma_y_range,
                                rotation_range, isotropic)
    if rng.uniform() < 0.5:
        beta = rng.uniform(beta_range[0], 1)
    else:
        beta = rng.uniform(1, beta_range[1])
    k = bivariate_plateau(kernel_size, sx, sy, rot, beta, isotropic=isotropic)
    return _apply_kernel_noise(k, rng, noise_range)


def random_mixed_kernels(kernel_list, kernel_prob, kernel_size=21,
                         sigma_x_range=(0.6, 5), sigma_y_range=(0.6, 5),
                         rotation_range=(-math.pi, math.pi),
                         betag_range=(0.5, 8), betap_range=(0.5, 8),
                         noise_range=None, rng=None) -> np.ndarray:
    """Sample a kernel type by probability, then its parameters."""
    rng = rng or np.random.default_rng()
    p = np.asarray(kernel_prob, dtype=np.float64)
    kernel_type = rng.choice(list(kernel_list), p=p / p.sum())
    common = dict(kernel_size=kernel_size, sigma_x_range=sigma_x_range,
                  sigma_y_range=sigma_y_range, rotation_range=rotation_range,
                  noise_range=noise_range, rng=rng)
    if kernel_type == "iso":
        return random_bivariate_gaussian(isotropic=True, **common)
    if kernel_type == "aniso":
        return random_bivariate_gaussian(isotropic=False, **common)
    if kernel_type == "generalized_iso":
        return random_bivariate_generalized_gaussian(
            beta_range=betag_range, isotropic=True, **common)
    if kernel_type == "generalized_aniso":
        return random_bivariate_generalized_gaussian(
            beta_range=betag_range, isotropic=False, **common)
    common["noise_range"] = None
    if kernel_type == "plateau_iso":
        return random_bivariate_plateau(beta_range=betap_range,
                                        isotropic=True, **common)
    if kernel_type == "plateau_aniso":
        return random_bivariate_plateau(beta_range=betap_range,
                                        isotropic=False, **common)
    raise ValueError(f"Unknown kernel type {kernel_type}")


def circular_lowpass_kernel(cutoff: float, kernel_size: int,
                            pad_to: int = 0) -> np.ndarray:
    """2D circularly-symmetric sinc low-pass filter (jinc), cutoff in
    radians. Center value is the analytic limit cutoff^2/(4*pi)."""
    assert kernel_size % 2 == 1, "Kernel size must be odd."
    c = (kernel_size - 1) / 2
    y, x = np.mgrid[0:kernel_size, 0:kernel_size].astype(np.float64)
    r = np.sqrt((x - c) ** 2 + (y - c) ** 2)
    with np.errstate(divide="ignore", invalid="ignore"):
        kernel = cutoff * special.j1(cutoff * r) / (2 * np.pi * r)
    kernel[int(c), int(c)] = cutoff ** 2 / (4 * np.pi)
    kernel = kernel / kernel.sum()
    if pad_to > kernel_size:
        pad = (pad_to - kernel_size) // 2
        kernel = np.pad(kernel, ((pad, pad), (pad, pad)))
    return kernel
