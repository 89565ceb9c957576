"""The port's degradation pieces against the JAX package's on the CPU: the
blur kernels (data/degradations.py), ``RealESRGANDataset`` items, the
per-sample blur, USM sharpening, DiffJPEG and its gradient, the noise
functions and the LDL artifact map (ops/degrade.py, ops/diffjpeg.py,
losses/basic.py), on inputs drawn with numpy from a seed.

Tolerances: the kernels and the dataset's items are the same numpy code on
the same generator states: equal. The blur, USM, JPEG and artifact map
within 1e-5 (float32, different summation orders); the JPEG's gradient
within 1e-5 of its largest entry. The noise: where the range is 0 the
output is the clipped input exactly, in both packages; elsewhere the two
draw different numbers (torch's generator against ``jax.random``, by
design), so their residuals over 196 608 pixels of 4096 samples are
compared in distribution: means within 5e-4 and standard deviations within
2 % relative (the sampling error of either is about 0.5 %, most of it from
the per-sample sigma or scale).
"""

import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from super_resolution_tpu.data import degradations as jdeg
from super_resolution_tpu.losses import basic as jbasic
from super_resolution_tpu.ops import degrade as jdegrade
from super_resolution_tpu.ops import diffjpeg as jjpeg
from super_resolution_tpu_torch.data import degradations as tdeg
from super_resolution_tpu_torch.losses import basic as tbasic
from super_resolution_tpu_torch.ops import degrade as tdegrade
from super_resolution_tpu_torch.ops import diffjpeg as tjpeg
from torch_threads import few_torch_threads  # noqa: F401

ATOL = 1e-5
NOISE_MEAN_ATOL = 5e-4
NOISE_STD_RTOL = 0.02
KERNEL_TYPES = ["iso", "aniso", "generalized_iso", "generalized_aniso",
                "plateau_iso", "plateau_aniso"]



def _img(rng, b=3, h=48, w=40):
    x = rng.random((b, h, w, 3)).astype(np.float32)
    return 0.25 * (x + np.roll(x, 1, 1) + np.roll(x, 1, 2)
                   + np.roll(x, (1, 1), (1, 2)))


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ host kernels
@pytest.mark.parametrize("kind", KERNEL_TYPES + ["sinc"])
def test_blur_kernels_equal_jax(kind):
    """Each kernel family (and the sinc) from the same generator state, at
    several sizes, with the kernel noise where the family takes it."""
    for size in (7, 13, 21):
        seed = size * 31
        if kind == "sinc":
            for cutoff in (np.pi / 5, 2.0, np.pi):
                np.testing.assert_array_equal(
                    tdeg.circular_lowpass_kernel(cutoff, size, pad_to=21),
                    jdeg.circular_lowpass_kernel(cutoff, size, pad_to=21))
            continue
        kw = dict(kernel_size=size, sigma_x_range=(0.2, 3),
                  sigma_y_range=(0.2, 3), rotation_range=(-np.pi, np.pi),
                  betag_range=(0.5, 4), betap_range=(1, 2),
                  noise_range=(0.8, 1.2))
        got = tdeg.random_mixed_kernels(
            [kind], [1.0], rng=np.random.default_rng(seed), **kw)
        ref = jdeg.random_mixed_kernels(
            [kind], [1.0], rng=np.random.default_rng(seed), **kw)
        np.testing.assert_array_equal(got, ref)
        assert got.shape == (size, size)
        np.testing.assert_allclose(got.sum(), 1.0, rtol=1e-9)


def test_dataset_items_equal_jax(tmp_path):
    """``RealESRGANDataset`` of both packages on the same folder (images
    smaller and larger than the canvas), reseeded alike: every item's GT
    and kernels equal, through the flips, the pad, the crop and both
    kernel draws."""
    import cv2

    from super_resolution_tpu.data.realesrgan_dataset import \
        RealESRGANDataset as JDataset
    from super_resolution_tpu_torch.data import build_dataset

    rng = np.random.default_rng(3)
    for i, (h, w) in enumerate([(40, 52), (70, 64), (64, 80)]):
        cv2.imwrite(str(tmp_path / f"{i}.png"),
                    (rng.random((h, w, 3)) * 255).astype(np.uint8))
    with open(os.path.join(os.path.dirname(os.path.dirname(__file__)),
                           "options/train/train_Real_HAT_SRx4_mse_model.yml")
              ) as f:
        opt = yaml.safe_load(f)["datasets"]["train"]
    opt.update(dataroot_gt=str(tmp_path), crop_pad_size=56, use_rot=True,
               sinc_prob=0.3, sinc_prob2=0.3, final_sinc_prob=0.5,
               phase="train")
    ours, theirs = build_dataset(opt), JDataset(opt)
    assert type(ours).__name__ == "RealESRGANDataset"
    for epoch_seed in (0, 7919):
        ours.seed(epoch_seed)
        theirs.seed(epoch_seed)
        for idx in (0, 1, 2, 1, 0, 2):
            got, ref = ours[idx], theirs[idx]
            assert sorted(got) == sorted(ref)
            assert got["gt"].shape == (56, 56, 3)
            for key in ("gt", "kernel1", "kernel2", "sinc_kernel"):
                np.testing.assert_array_equal(got[key], ref[key],
                                              err_msg=key)
            assert got["gt_path"] == ref["gt_path"]


# ----------------------------------------------------------- device ops
@pytest.mark.parametrize("shared", [True, False])
def test_filter2d_batch_matches_jax(shared):
    rng = np.random.default_rng(0)
    img = _img(rng)
    k = rng.random((1 if shared else 3, 21, 21)).astype(np.float32)
    k /= k.sum(axis=(1, 2), keepdims=True)
    got = tdegrade.filter2d_batch(_t(img), _t(k)).numpy()
    ref = np.asarray(jdegrade.filter2d_batch(jnp.asarray(img),
                                             jnp.asarray(k)))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    with pytest.raises(ValueError):
        tdegrade.filter2d_batch(_t(img), torch.ones(1, 4, 4))


def test_usm_sharp_matches_jax():
    rng = np.random.default_rng(1)
    img = _img(rng, h=64, w=72)
    kern = tdegrade.usm_gaussian_kernel(50)
    np.testing.assert_array_equal(kern, jdegrade.usm_gaussian_kernel(50))
    got = tdegrade.usm_sharp(_t(img), _t(kern)).numpy()
    ref = np.asarray(jdegrade.usm_sharp(jnp.asarray(img), kern))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("quality,differentiable", [
    ([30.0, 60.0, 95.0], True), ([10.0, 49.5, 77.25], True),
    ([50.0, 50.0, 50.0], False)])
def test_jpeg_matches_jax(quality, differentiable):
    """Per-sample qualities on both sides of 50, on an image whose sides are
    no multiple of 16 (the pad and crop)."""
    rng = np.random.default_rng(2)
    img = _img(rng, h=40, w=56)
    got = tjpeg.jpeg_compress_decompress(_t(img), torch.tensor(quality),
                                         differentiable).numpy()
    ref = np.asarray(jjpeg.jpeg_compress_decompress(
        jnp.asarray(img), jnp.asarray(quality), differentiable))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    assert float(np.abs(got - img).max()) > 0.01


def test_jpeg_gradient_matches_jax():
    """The gradient through ``diff_round`` against ``jax.grad``."""
    rng = np.random.default_rng(4)
    img = _img(rng, b=2, h=32, w=48)
    w = rng.standard_normal(img.shape).astype(np.float32)
    q = np.asarray([35.0, 80.0], np.float32)
    ref = np.asarray(jax.grad(lambda x: jnp.sum(
        jjpeg.jpeg_compress_decompress(x, jnp.asarray(q)) * w))(
        jnp.asarray(img)))
    x = _t(img).requires_grad_(True)
    (tjpeg.jpeg_compress_decompress(x, _t(q)) * _t(w)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), ref,
                               atol=ATOL * np.abs(ref).max(), rtol=0)


def test_artifact_map_matches_jax():
    rng = np.random.default_rng(5)
    gt, out, ema = (_img(rng, b=2, h=24, w=32) for _ in range(3))
    got = tbasic.get_refined_artifact_map(_t(gt), _t(out), _t(ema), 7)
    ref = np.asarray(jbasic.get_refined_artifact_map(
        jnp.asarray(gt), jnp.asarray(out), jnp.asarray(ema), 7))
    assert got.shape == (2, 24, 32, 1)
    assert (ref == 0).any() and (ref > 0).any()
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


# ------------------------------------------------------------------ noise
@pytest.mark.parametrize("kind", ["gaussian", "poisson"])
def test_noise_with_a_zero_range_is_exact(kind):
    """Range 0: both packages return the clipped input, whatever they draw
    (the gray choice and the draws included)."""
    rng = np.random.default_rng(6)
    img = _img(rng) * 1.2 - 0.1
    g = torch.Generator().manual_seed(0)
    if kind == "gaussian":
        got = tdegrade.add_gaussian_noise(_t(img), (0, 0), 0.5, generator=g)
        ref = jdegrade.add_gaussian_noise(jax.random.PRNGKey(0),
                                          jnp.asarray(img), (0, 0), 0.5)
    else:
        got = tdegrade.add_poisson_noise(_t(img), (0, 0), 0.5, generator=g)
        ref = jdegrade.add_poisson_noise(jax.random.PRNGKey(0),
                                         jnp.asarray(img), (0, 0), 0.5)
    np.testing.assert_array_equal(got.numpy(), np.clip(img, 0, 1))
    np.testing.assert_array_equal(np.asarray(ref), np.clip(img, 0, 1))


@pytest.mark.parametrize("kind,value_range", [
    ("gaussian", (5.0, 15.0)), ("poisson", (0.5, 1.5))])
def test_noise_matches_jax_in_distribution(kind, value_range):
    """Over 4096 samples of 4 x 4 x 3 (196 608 pixels) in [0.2, 0.8]
    (nothing clipped; many samples, since each draws its own sigma or
    scale): the residual's mean and standard deviation against JAX's
    draws; gray_prob 1 gives one noise plane for the three channels in
    both, gray_prob 0 three."""
    rng = np.random.default_rng(7)
    img = (0.2 + 0.6 * rng.random((4096, 4, 4, 3))).astype(np.float32)
    g = torch.Generator().manual_seed(1)
    fn = {"gaussian": (tdegrade.add_gaussian_noise,
                       jdegrade.add_gaussian_noise),
          "poisson": (tdegrade.add_poisson_noise,
                      jdegrade.add_poisson_noise)}[kind]
    for gray in (0.0, 1.0):
        got = fn[0](_t(img), value_range, gray, generator=g).numpy() - img
        ref = np.asarray(fn[1](jax.random.PRNGKey(int(gray)),
                               jnp.asarray(img), value_range, gray)) - img
        assert abs(got.mean() - ref.mean()) <= NOISE_MEAN_ATOL
        np.testing.assert_allclose(got.std(), ref.std(),
                                   rtol=NOISE_STD_RTOL)
        for res in (got, ref):
            planes_equal = np.allclose(res[..., 0], res[..., 1], atol=1e-6)
            assert planes_equal == (gray == 1.0)
