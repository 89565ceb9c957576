"""Real-ESRGAN training dataset: GT images and the degradation kernels of
each item (port of super_resolution_tpu/data/realesrgan_dataset.py; ref:
hat/data/realesrgan_dataset.py:16-194).

An item is the GT only, flipped, reflect-padded or cropped to a canvas of
``crop_pad_size`` (400), with ``kernel1``, ``kernel2`` (the mixed blur
family, or a sinc) and ``sinc_kernel`` (a sinc, or the unit pulse), each
padded to 21 x 21. The degradation itself runs on the device in the real-world
runners (runtime/realgan.py). The draws come from two generators, a numpy
``default_rng`` and a ``random.Random``, in the JAX package's order; the
train loader reseeds both every epoch, so a seed gives JAX's items.
"""

from __future__ import annotations

import math
import random as pyrandom
from os import path as osp

import numpy as np

from super_resolution_tpu_torch.data.degradations import (
    circular_lowpass_kernel, random_mixed_kernels)
from super_resolution_tpu_torch.data.paired_dataset import _check_supported
from super_resolution_tpu_torch.data.transforms import augment
from super_resolution_tpu_torch.utils.img import img2tensor, imread
from super_resolution_tpu_torch.utils.misc import scandir
from super_resolution_tpu_torch.utils.registry import DATASET_REGISTRY

KERNEL_SIZE = 21


@DATASET_REGISTRY.register()
class RealESRGANDataset:
    """GT images from ``dataroot_gt`` (or the names a ``meta_info`` file
    lists there) with their three kernels."""

    def __init__(self, opt: dict):
        _check_supported(opt)
        self.opt = opt
        self.gt_folder = opt["dataroot_gt"]
        if opt.get("meta_info"):
            with open(opt["meta_info"], "r") as f:
                self.paths = [osp.join(self.gt_folder,
                                       line.strip().split(" ")[0])
                              for line in f if line.strip()]
        else:
            self.paths = sorted(scandir(self.gt_folder, full_path=True))
        self.crop_pad_size = opt.get("crop_pad_size", 400)
        self.kernel_range = [2 * v + 1 for v in range(3, 11)]  # 7 .. 21
        self.pulse_tensor = np.zeros((KERNEL_SIZE, KERNEL_SIZE), np.float32)
        self.pulse_tensor[10, 10] = 1.0
        self.seed(0)

    def seed(self, seed: int) -> None:
        """Reseed both generators (the train loader, every epoch)."""
        self._rng = np.random.default_rng(seed)
        self._pyrng = pyrandom.Random(seed)

    def __len__(self):
        return len(self.paths)

    def _sample_kernel(self, sinc_prob, kernel_list, kernel_prob, blur_sigma,
                       betag_range, betap_range) -> np.ndarray:
        kernel_size = self._pyrng.choice(self.kernel_range)
        if self._rng.uniform() < sinc_prob:
            omega_lo = np.pi / 3 if kernel_size < 13 else np.pi / 5
            omega_c = self._rng.uniform(omega_lo, np.pi)
            kernel = circular_lowpass_kernel(omega_c, kernel_size, pad_to=0)
        else:
            kernel = random_mixed_kernels(
                kernel_list, kernel_prob, kernel_size, blur_sigma, blur_sigma,
                [-math.pi, math.pi], betag_range, betap_range,
                noise_range=None, rng=self._rng)
        pad = (KERNEL_SIZE - kernel_size) // 2
        return np.pad(kernel, ((pad, pad), (pad, pad))).astype(np.float32)

    def __getitem__(self, index: int) -> dict:
        opt = self.opt
        # a read error draws another image, three times (ref: :93-107)
        for _ in range(3):
            try:
                img_gt = imread(self.paths[index], float32=True)
                break
            except Exception:
                index = self._pyrng.randint(0, len(self.paths) - 1)
        else:
            raise IOError(f"Failed to read {self.paths[index]}")

        img_gt = augment(img_gt, opt.get("use_hflip", True),
                         opt.get("use_rot", True), rng=self._pyrng)

        # reflect-pad, then crop, to the canvas
        cps = self.crop_pad_size
        h, w = img_gt.shape[:2]
        if h < cps or w < cps:
            img_gt = np.pad(img_gt, ((0, max(0, cps - h)),
                                     (0, max(0, cps - w)), (0, 0)),
                            mode="reflect")
        h, w = img_gt.shape[:2]
        if h > cps or w > cps:
            top = self._pyrng.randint(0, h - cps)
            left = self._pyrng.randint(0, w - cps)
            img_gt = img_gt[top:top + cps, left:left + cps, :]

        kernel1 = self._sample_kernel(
            opt["sinc_prob"], opt["kernel_list"], opt["kernel_prob"],
            opt["blur_sigma"], opt["betag_range"], opt["betap_range"])
        kernel2 = self._sample_kernel(
            opt["sinc_prob2"], opt["kernel_list2"], opt["kernel_prob2"],
            opt["blur_sigma2"], opt["betag_range2"], opt["betap_range2"])

        if self._rng.uniform() < opt["final_sinc_prob"]:
            kernel_size = self._pyrng.choice(self.kernel_range)
            omega_c = self._rng.uniform(np.pi / 3, np.pi)
            sinc_kernel = circular_lowpass_kernel(
                omega_c, kernel_size, pad_to=KERNEL_SIZE).astype(np.float32)
        else:
            sinc_kernel = self.pulse_tensor

        return {"gt": img2tensor(img_gt, bgr2rgb=True),
                "kernel1": kernel1, "kernel2": kernel2,
                "sinc_kernel": sinc_kernel, "gt_path": self.paths[index]}
