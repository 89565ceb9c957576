"""The port's copies of the evaluation arithmetic against the JAX package's
originals: PSNR and SSIM on the MATLAB protocol, the BT.601 colour
conversions, the MATLAB bicubic resize and the metric registry.

The copies are numpy on both sides, so colour conversions are held equal,
the metrics to 1e-10 and the resize to 1e-6."""

import numpy as np
import pytest

from super_resolution_tpu.metrics import psnr_ssim as j_metrics
from super_resolution_tpu.utils import color as j_color
from super_resolution_tpu.utils import matlab as j_matlab
from super_resolution_tpu_torch.metrics import psnr_ssim as t_metrics
from super_resolution_tpu_torch.utils import color as t_color
from super_resolution_tpu_torch.utils import matlab as t_matlab


def _pair(rng, order):
    """A uint8 image and a noisy copy of it (PSNR in the 20s), HWC or
    CHW."""
    img = rng.integers(0, 256, (33, 41, 3)).astype(np.uint8)
    noise = rng.normal(0, 12, img.shape)
    img2 = np.clip(img + noise, 0, 255).round().astype(np.uint8)
    if order == "CHW":
        img, img2 = img.transpose(2, 0, 1), img2.transpose(2, 0, 1)
    return img, img2


@pytest.mark.parametrize("order", ["HWC", "CHW"])
@pytest.mark.parametrize("test_y", [False, True])
@pytest.mark.parametrize("crop", [0, 4])
@pytest.mark.parametrize("metric", ["calculate_psnr", "calculate_ssim"])
def test_metric_matches_jax(rng, metric, crop, test_y, order):
    img, img2 = _pair(rng, order)
    kw = dict(crop_border=crop, input_order=order, test_y_channel=test_y)
    got = getattr(t_metrics, metric)(img, img2, **kw)
    ref = getattr(j_metrics, metric)(img, img2, **kw)
    assert isinstance(got, float) or np.isscalar(got)
    assert abs(got - ref) <= 1e-10, (got, ref)


def test_psnr_of_equal_images_is_infinite(rng):
    img, _ = _pair(rng, "HWC")
    assert t_metrics.calculate_psnr(img, img.copy(), 0) == float("inf")
    assert t_metrics.calculate_ssim(img, img.copy(), 0) == pytest.approx(1.0)


def test_gaussian_window_matches_jax():
    np.testing.assert_array_equal(t_metrics.gaussian_kernel_1d(11, 1.5),
                                  j_metrics.gaussian_kernel_1d(11, 1.5))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("y_only", [False, True])
@pytest.mark.parametrize("fn", ["rgb2ycbcr", "bgr2ycbcr"])
def test_ycbcr_matches_jax(rng, fn, y_only, dtype):
    img = rng.integers(0, 256, (9, 11, 3)).astype(np.uint8)
    if dtype == np.float32:
        img = img.astype(np.float32) / 255.0
    got = getattr(t_color, fn)(img, y_only=y_only)
    ref = getattr(j_color, fn)(img, y_only=y_only)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_ycbcr2rgb_and_y_channel_match_jax(rng, dtype):
    img = rng.integers(16, 236, (9, 11, 3)).astype(np.uint8)
    if dtype == np.float32:
        img = img.astype(np.float32) / 255.0
    np.testing.assert_array_equal(t_color.ycbcr2rgb(img),
                                  j_color.ycbcr2rgb(img))
    np.testing.assert_array_equal(t_color.to_y_channel(img),
                                  j_color.to_y_channel(img))


@pytest.mark.parametrize("scale", [1 / 2, 1 / 3, 1 / 4, 2])
@pytest.mark.parametrize("shape", [(37, 45, 3), (29, 31), (57, 86, 3)])
def test_imresize_matches_jax(rng, shape, scale):
    img = rng.random(shape, dtype=np.float32)
    got = t_matlab.imresize(img, scale)
    ref = j_matlab.imresize(img, scale)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_resize_weights_match_jax():
    for args in ((37, 10, 1 / 4), (45, 15, 1 / 3), (12, 24, 2.0)):
        for a, b in zip(t_matlab.resize_weights_indices(*args),
                        j_matlab.resize_weights_indices(*args)):
            np.testing.assert_array_equal(a, b)


def test_calculate_metric_dispatch_and_registry(rng):
    from super_resolution_tpu.metrics import calculate_metric as j_calc
    from super_resolution_tpu_torch.metrics import (METRIC_REGISTRY,
                                                    calculate_metric)

    img, img2 = _pair(rng, "HWC")
    data = {"img": img, "img2": img2}
    for opt in ({"type": "calculate_psnr", "crop_border": 4,
                 "test_y_channel": True},
                {"type": "calculate_ssim", "crop_border": 4,
                 "test_y_channel": True, "better": "higher"}):
        assert calculate_metric(data, opt) == j_calc(data, opt)
        assert "type" in opt     # the options are not consumed
    # NIQE is registered; FID, a statistic of two sets, is not
    assert sorted(METRIC_REGISTRY.keys()) == ["calculate_niqe",
                                              "calculate_psnr",
                                              "calculate_ssim"]
    with pytest.raises(KeyError, match="calculate_psnr"):
        calculate_metric(data, {"type": "calculate_fid", "crop_border": 0})
