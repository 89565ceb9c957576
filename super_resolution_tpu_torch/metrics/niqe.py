"""NIQE, the no-reference image quality metric, with MATLAB parity (a copy
of super_resolution_tpu/metrics/niqe.py, numpy and scipy only).

A rebuild of the reference's implementation (ref:
basicsr/metrics/niqe.py:12-199, itself matching the official MATLAB
release), its per-block loops vectorised: every block's AGGD parameters
are estimated at once against the shared (9801,) gamma-ratio grid.

niqe_pris_params.npz, beside this file, is the official pristine-model
statistics (mean and covariance of the features fitted on the pristine
set, and the 7 x 7 Gaussian window) of the original NIQE release (LIVE
lab, UT Austin), a public data asset BasicSR redistributes, kept here
unchanged (a copy of the JAX package's file).
"""

from __future__ import annotations

import math
import os

import numpy as np
from scipy.ndimage import convolve
from scipy.special import gamma as gamma_fn

from super_resolution_tpu_torch.utils.color import to_y_channel
from super_resolution_tpu_torch.utils.matlab import imresize
from super_resolution_tpu_torch.utils.registry import METRIC_REGISTRY

_GAM = np.arange(0.2, 10.001, 0.001)
_R_GAM = (np.square(gamma_fn(2.0 / _GAM))
          / (gamma_fn(1.0 / _GAM) * gamma_fn(3.0 / _GAM)))


def _aggd_params_batch(blocks: np.ndarray):
    """Vectorized AGGD parameter estimation.

    blocks: (N, P) flattened blocks. Returns (alpha, beta_l, beta_r),
    each (N,).
    """
    neg = blocks < 0
    pos = blocks > 0
    with np.errstate(invalid="ignore", divide="ignore"):
        left_std = np.sqrt((blocks ** 2 * neg).sum(1) /
                           np.maximum(neg.sum(1), 1e-12))
        right_std = np.sqrt((blocks ** 2 * pos).sum(1) /
                            np.maximum(pos.sum(1), 1e-12))
        gammahat = left_std / right_std
        rhat = np.abs(blocks).mean(1) ** 2 / (blocks ** 2).mean(1)
        rhatnorm = (rhat * (gammahat ** 3 + 1) * (gammahat + 1)
                    / (gammahat ** 2 + 1) ** 2)
    idx = np.argmin((_R_GAM[None, :] - rhatnorm[:, None]) ** 2, axis=1)
    alpha = _GAM[idx]
    ratio = np.sqrt(gamma_fn(1.0 / alpha) / gamma_fn(3.0 / alpha))
    return alpha, left_std * ratio, right_std * ratio


def _block_features(blocks: np.ndarray) -> np.ndarray:
    """blocks: (N, bh, bw) -> (N, 18) NIQE features."""
    n = blocks.shape[0]
    feats = np.empty((n, 18))
    alpha, bl, br = _aggd_params_batch(blocks.reshape(n, -1))
    feats[:, 0] = alpha
    feats[:, 1] = (bl + br) / 2
    shifts = [(0, 1), (1, 0), (1, 1), (1, -1)]
    for i, sh in enumerate(shifts):
        shifted = np.roll(blocks, sh, axis=(1, 2))
        alpha, bl, br = _aggd_params_batch((blocks * shifted).reshape(n, -1))
        mean = (br - bl) * (gamma_fn(2.0 / alpha) / gamma_fn(1.0 / alpha))
        feats[:, 2 + 4 * i:6 + 4 * i] = np.stack([alpha, mean, bl, br], 1)
    return feats


def _load_pris_params():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "niqe_pris_params.npz")
    d = np.load(path)
    return d["mu_pris_param"], d["cov_pris_param"], d["gaussian_window"]


def niqe_core(img: np.ndarray, mu_pris, cov_pris, gaussian_window,
              block_size_h: int = 96, block_size_w: int = 96) -> float:
    """img: (H, W) float [0,255] gray/Y image."""
    assert img.ndim == 2
    h, w = img.shape
    nbh = math.floor(h / block_size_h)
    nbw = math.floor(w / block_size_w)
    img = img[:nbh * block_size_h, :nbw * block_size_w].astype(np.float64)

    distparam = []
    for scale in (1, 2):
        mu = convolve(img, gaussian_window, mode="nearest")
        sigma = np.sqrt(np.abs(convolve(img ** 2, gaussian_window,
                                        mode="nearest") - mu ** 2))
        normalized = (img - mu) / (sigma + 1)
        bh, bw = block_size_h // scale, block_size_w // scale
        # block order must match the reference's (idx_w outer, idx_h inner)
        blocks = normalized.reshape(nbh, bh, nbw, bw).transpose(2, 0, 1, 3)
        blocks = blocks.reshape(nbh * nbw, bh, bw)
        distparam.append(_block_features(blocks))
        if scale == 1:
            img = imresize(img / 255.0, 0.5, antialiasing=True) * 255.0
            img = img.astype(np.float64)

    distparam = np.concatenate(distparam, axis=1)
    mu_dist = np.nanmean(distparam, axis=0)
    good = distparam[~np.isnan(distparam).any(axis=1)]
    cov_dist = np.cov(good, rowvar=False)
    invcov = np.linalg.pinv((cov_pris + cov_dist) / 2)
    d = mu_pris - mu_dist
    return float(np.squeeze(np.sqrt(d @ invcov @ d.T)))


@METRIC_REGISTRY.register()
def calculate_niqe(img, crop_border, input_order="HWC", convert_to="y",
                   **kwargs) -> float:
    """NIQE of a BGR [0,255] image (protocol-identical to the reference)."""
    mu_pris, cov_pris, gwin = _load_pris_params()
    img = np.asarray(img).astype(np.float32)
    if input_order != "HW":
        if input_order == "CHW":
            img = img.transpose(1, 2, 0)
        if convert_to == "y":
            img = to_y_channel(img)
        elif convert_to == "gray":
            w = np.array([0.114, 0.587, 0.299])  # BGR gray
            img = (img / 255.0) @ w * 255.0
        img = np.squeeze(img)
    if crop_border != 0:
        img = img[crop_border:-crop_border, crop_border:-crop_border]
    img = img.round()
    return niqe_core(img, mu_pris, cov_pris, gwin)
