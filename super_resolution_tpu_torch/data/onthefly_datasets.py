"""GT-only datasets that make their LQ on the fly (port of
super_resolution_tpu/data/onthefly_datasets.py).

- ImageNetPairedDataset (ref: hat/data/imagenet_paired_dataset.py:14-92):
  mod crop, an upscale where the image is smaller than ``gt_size``, a
  random crop, the flips; LQ = MATLAB bicubic downscale of the GT crop.
- DownsampleImageDataset (ref: HAT/ESC/esc/data/downsample_dataset.py:
  47-131): a random crop (at 0 where the image is no larger than
  ``gt_size``), the flips and the bicubic downscale; the ESC recipe uses
  PIL's bicubic, the JAX package and this port the MATLAB kernel that every
  SR benchmark assumes.

The images are read from ``dataroot_gt``, or the names a
``meta_info_file`` lists there. Every draw comes from the dataset's own
``random.Random`` (seed 0 until the train loader reseeds it every epoch),
in the JAX package's order, so a seed gives JAX's crops and flips.
"""

from __future__ import annotations

import random
from os import path as osp

import numpy as np

from super_resolution_tpu_torch.data.paired_dataset import _check_supported
from super_resolution_tpu_torch.data.transforms import augment, mod_crop
from super_resolution_tpu_torch.utils.img import img2tensor, imread
from super_resolution_tpu_torch.utils.matlab import imresize
from super_resolution_tpu_torch.utils.misc import scandir
from super_resolution_tpu_torch.utils.registry import DATASET_REGISTRY


class _GTOnlyBase:
    """The GT paths and the draws' generator the two datasets share."""

    def __init__(self, opt: dict):
        _check_supported(opt)
        self.opt = opt
        self.gt_folder = opt["dataroot_gt"]
        if opt.get("meta_info_file"):
            with open(opt["meta_info_file"], "r") as f:
                self.paths = [osp.join(self.gt_folder,
                                       line.strip().split(" ")[0])
                              for line in f if line.strip()]
        else:
            self.paths = sorted(scandir(self.gt_folder, full_path=True))
        self._rng = random.Random(0)

    def seed(self, seed: int) -> None:
        """Reseed the crops and flips (the train loader, every epoch)."""
        self._rng = random.Random(seed)

    def __len__(self):
        return len(self.paths)

    def _item(self, img_gt: np.ndarray, gt_path: str) -> dict:
        img_lq = np.clip(imresize(np.ascontiguousarray(img_gt),
                                  1.0 / self.opt["scale"]), 0, 1)
        return {"lq": img_lq.astype(np.float32),
                "gt": np.ascontiguousarray(img_gt, np.float32),
                "lq_path": gt_path, "gt_path": gt_path}


@DATASET_REGISTRY.register()
class ImageNetPairedDataset(_GTOnlyBase):

    def __getitem__(self, index: int) -> dict:
        scale = self.opt["scale"]
        gt_size = self.opt.get("gt_size")
        gt_path = self.paths[index]
        img_gt = mod_crop(img2tensor(imread(gt_path, float32=True)), scale)

        if self.opt.get("phase") == "train":
            h, w = img_gt.shape[:2]
            # upscale small images so that a gt_size crop exists (ref:
            # :44-52)
            if gt_size and (h < gt_size or w < gt_size):
                s = max(gt_size / h, gt_size / w)
                img_gt = mod_crop(np.clip(imresize(img_gt, s), 0, 1), scale)
                h, w = img_gt.shape[:2]
            if gt_size:
                top = self._rng.randint(0, h - gt_size)
                left = self._rng.randint(0, w - gt_size)
                img_gt = img_gt[top:top + gt_size, left:left + gt_size]
            img_gt = augment(img_gt, self.opt.get("use_hflip", True),
                             self.opt.get("use_rot", True), rng=self._rng)
        return self._item(img_gt, gt_path)


@DATASET_REGISTRY.register()
class DownsampleImageDataset(_GTOnlyBase):

    def __getitem__(self, index: int) -> dict:
        gt_size = self.opt.get("gt_size")
        gt_path = self.paths[index]
        img_gt = img2tensor(imread(gt_path, float32=True))

        if self.opt.get("phase") == "train" and gt_size:
            h, w = img_gt.shape[:2]
            top = self._rng.randint(0, max(0, h - gt_size))
            left = self._rng.randint(0, max(0, w - gt_size))
            img_gt = img_gt[top:top + gt_size, left:left + gt_size]
            img_gt = augment(img_gt, self.opt.get("use_hflip", True),
                             self.opt.get("use_rot", True), rng=self._rng)
        else:
            img_gt = mod_crop(img_gt, self.opt["scale"])
        return self._item(img_gt, gt_path)
