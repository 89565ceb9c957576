"""Metric registry and factory (port of
super_resolution_tpu/metrics/__init__.py; ref:
HAT/ESC/basicsr/metrics/__init__.py:10-20). Registered: ``calculate_psnr``,
``calculate_ssim`` and ``calculate_niqe``; the batched on-device
``calculate_psnr_pt`` / ``calculate_ssim_pt`` (the JAX ``_jnp`` functions)
are exported beside them. FID (``metrics/fid.py``) is a statistic of two
sets of images, not of one image, and stays out of the registry, as in
JAX."""

from copy import deepcopy

from super_resolution_tpu_torch.metrics.niqe import calculate_niqe  # noqa: F401
from super_resolution_tpu_torch.metrics.psnr_ssim import (  # noqa: F401
    calculate_psnr, calculate_psnr_pt, calculate_ssim, calculate_ssim_pt)
from super_resolution_tpu_torch.utils.registry import METRIC_REGISTRY

__all__ = ["calculate_metric", "calculate_niqe", "calculate_psnr",
           "calculate_psnr_pt", "calculate_ssim", "calculate_ssim_pt",
           "METRIC_REGISTRY"]


def calculate_metric(data: dict, opt: dict):
    """Dispatch on opt['type'] through the metric registry."""
    opt = deepcopy(opt)
    metric_type = opt.pop("type")
    return METRIC_REGISTRY.get(metric_type)(**data, **opt)
