"""Arbitrary-scale dataset wrappers (port of super_resolution_tpu/arb/
data.py; ref: esc_arb/datasets/wrappers.py).

``SRImplicitDownsampled``: a scale s drawn in [scale_min, scale_max] for
each item; an s * inp_size GT crop bicubic-downscaled to inp_size (or, with
no ``inp_size``, the whole image and its 1 / s downscale); flips; then
(inp, coord, cell, gt) at ``sample_q`` GT pixels. ``SRImplicitPaired``:
fixed-scale LQ / GT pairs as the same samples. Every draw comes from the
wrapper's ``random.Random`` (seed 0 until the train loader reseeds it) in
the JAX package's order (scale, crop, flips, pixel sample), so a seed gives
JAX's items. The downscale is the port's MATLAB bicubic.
"""

from __future__ import annotations

import math
import random

import numpy as np

from super_resolution_tpu_torch.arb.models import to_pixel_samples
from super_resolution_tpu_torch.data.transforms import augment
from super_resolution_tpu_torch.utils.matlab import imresize
from super_resolution_tpu_torch.utils.registry import DATASET_REGISTRY


def _samples(crop_hr: np.ndarray, rng: random.Random, sample_q):
    """The GT pixels' (coord, rgb), ``sample_q`` of them drawn without
    replacement where given, and each one's cell (2 / H, 2 / W)."""
    hr_coord, hr_rgb = to_pixel_samples(np.ascontiguousarray(crop_hr))
    if sample_q is not None:
        sel = np.asarray(rng.sample(range(len(hr_coord)), sample_q))
        hr_coord, hr_rgb = hr_coord[sel], hr_rgb[sel]
    cell = np.empty_like(hr_coord)
    cell[:, 0] = 2.0 / crop_hr.shape[0]
    cell[:, 1] = 2.0 / crop_hr.shape[1]
    return (hr_coord.astype(np.float32), cell.astype(np.float32),
            hr_rgb.astype(np.float32))


@DATASET_REGISTRY.register()
class SRImplicitDownsampled:
    """GT-only dataset -> (inp, coord, cell, gt) samples (ref:
    wrappers.py:156-224)."""

    def __init__(self, opt: dict):
        from super_resolution_tpu_torch.data import build_dataset

        self.opt = opt
        self.dataset = build_dataset(dict(opt["dataset"], phase="train"))
        self.inp_size = opt.get("inp_size")
        self.scale_min = opt.get("scale_min", 1)
        self.scale_max = opt.get("scale_max", 4)
        self.sample_q = opt.get("sample_q")
        self.augment = opt.get("augment", False)
        self._rng = random.Random(0)

    def seed(self, seed: int) -> None:
        self._rng = random.Random(seed)
        if hasattr(self.dataset, "seed"):
            self.dataset.seed(seed)

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx: int) -> dict:
        item = self.dataset[idx]
        img = item["gt"] if isinstance(item, dict) else item   # HWC [0, 1]
        s = self._rng.uniform(self.scale_min, self.scale_max)

        if self.inp_size is None:
            h_lr = math.floor(img.shape[0] / s + 1e-9)
            w_lr = math.floor(img.shape[1] / s + 1e-9)
            crop_hr = img[:round(h_lr * s), :round(w_lr * s), :]
            crop_lr = imresize(crop_hr, 1 / s)
        else:
            w_lr = self.inp_size
            w_hr = round(w_lr * s)
            x0 = self._rng.randint(0, img.shape[0] - w_hr)
            y0 = self._rng.randint(0, img.shape[1] - w_hr)
            crop_hr = img[x0:x0 + w_hr, y0:y0 + w_hr, :]
            crop_lr = imresize(crop_hr, w_lr / w_hr)[:w_lr, :w_lr, :]

        if self.augment:
            crop_lr, crop_hr = augment([crop_lr, crop_hr], True, True,
                                       rng=self._rng)
        coord, cell, gt = _samples(crop_hr, self._rng, self.sample_q)
        return {"inp": crop_lr.astype(np.float32), "coord": coord,
                "cell": cell, "gt": gt}


@DATASET_REGISTRY.register()
class SRImplicitPaired:
    """Fixed-scale LQ / GT pairs -> implicit samples (ref:
    wrappers.py:16-80)."""

    def __init__(self, opt: dict):
        from super_resolution_tpu_torch.data import build_dataset

        self.opt = opt
        self.dataset = build_dataset(dict(opt["dataset"], phase="val"))
        self.sample_q = opt.get("sample_q")
        self._rng = random.Random(0)

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx: int) -> dict:
        item = self.dataset[idx]
        img_lr, img_hr = item["lq"], item["gt"]
        s = img_hr.shape[0] // img_lr.shape[0]
        img_hr = img_hr[:img_lr.shape[0] * s, :img_lr.shape[1] * s, :]
        coord, cell, gt = _samples(img_hr, self._rng, self.sample_q)
        return {"inp": img_lr.astype(np.float32), "coord": coord,
                "cell": cell, "gt": gt, "lq_path": item.get("lq_path", "")}
