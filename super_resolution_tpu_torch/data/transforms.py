"""Paired crop and augmentation transforms (port of
super_resolution_tpu/data/transforms.py; ref: basicsr/data/transforms.py).

HWC numpy images in, HWC numpy images out. Every random draw comes from the
``random.Random`` the caller passes (the dataset's, reseeded each epoch by
the train loader), in the JAX package's order, so a seed gives the same
crops and flips in both packages."""

from __future__ import annotations

import random

import numpy as np


def mod_crop(img: np.ndarray, scale: int) -> np.ndarray:
    """Crop H and W down to multiples of scale (ref: transforms.py:6)."""
    h, w = img.shape[0], img.shape[1]
    return img[:h - h % scale, :w - w % scale, ...]


def paired_random_crop(img_gts, img_lqs, gt_patch_size: int, scale: int,
                       rng: random.Random | None = None):
    """Crops of LQ / GT pairs at the same place, the GT's scale times the
    LQ's (ref: transforms.py:26-91). Single images or lists of them."""
    rng = rng or random
    single_gt = not isinstance(img_gts, list)
    single_lq = not isinstance(img_lqs, list)
    if single_gt:
        img_gts = [img_gts]
    if single_lq:
        img_lqs = [img_lqs]

    h_lq, w_lq = img_lqs[0].shape[0], img_lqs[0].shape[1]
    h_gt, w_gt = img_gts[0].shape[0], img_gts[0].shape[1]
    lq_patch_size = gt_patch_size // scale

    if h_gt != h_lq * scale or w_gt != w_lq * scale:
        raise ValueError(f"GT size ({h_gt},{w_gt}) is not {scale}x LQ "
                         f"({h_lq},{w_lq})")
    if h_lq < lq_patch_size or w_lq < lq_patch_size:
        raise ValueError(f"LQ ({h_lq},{w_lq}) smaller than patch "
                         f"{lq_patch_size}")

    top = rng.randint(0, h_lq - lq_patch_size)
    left = rng.randint(0, w_lq - lq_patch_size)
    img_lqs = [v[top:top + lq_patch_size, left:left + lq_patch_size, ...]
               for v in img_lqs]
    top_gt, left_gt = top * scale, left * scale
    img_gts = [v[top_gt:top_gt + gt_patch_size,
                 left_gt:left_gt + gt_patch_size, ...] for v in img_gts]
    return (img_gts[0] if single_gt else img_gts,
            img_lqs[0] if single_lq else img_lqs)


def augment(imgs, hflip: bool = True, rotation: bool = True, flows=None,
            return_status: bool = False,
            rng: random.Random | None = None):
    """Horizontal flip, vertical flip and transpose, each with probability
    1/2, the same for every image of the list and for the optical flows,
    whose components flip sign and swap with them (ref:
    transforms.py:116-180)."""
    rng = rng or random
    do_hflip = hflip and rng.random() < 0.5
    do_vflip = rotation and rng.random() < 0.5
    do_rot90 = rotation and rng.random() < 0.5

    def _augment(img):
        if do_hflip:
            img = img[:, ::-1, ...]
        if do_vflip:
            img = img[::-1, :, ...]
        if do_rot90:
            img = img.transpose(1, 0, 2) if img.ndim == 3 else img.T
        return np.ascontiguousarray(img)

    def _augment_flow(flow):
        if do_hflip:
            flow = flow[:, ::-1, :].copy()
            flow[:, :, 0] *= -1
        if do_vflip:
            flow = flow[::-1, :, :].copy()
            flow[:, :, 1] *= -1
        if do_rot90:
            flow = flow.transpose(1, 0, 2)[:, :, [1, 0]]
        return np.ascontiguousarray(flow)

    def each(fn, items):
        return fn(items) if not isinstance(items, list) else [fn(v) for v
                                                              in items]

    imgs = each(_augment, imgs)
    status = (do_hflip, do_vflip, do_rot90)
    if flows is not None:
        flows = each(_augment_flow, flows)
        return (imgs, flows, status) if return_status else (imgs, flows)
    return (imgs, status) if return_status else imgs
