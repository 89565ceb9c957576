"""Metric registry and factory (port of
super_resolution_tpu/metrics/__init__.py; ref:
HAT/ESC/basicsr/metrics/__init__.py:10-20). Registered: ``calculate_psnr``
and ``calculate_ssim``; the jax variants, NIQE and FID are not ported."""

from copy import deepcopy

from super_resolution_tpu_torch.metrics.psnr_ssim import (  # noqa: F401
    calculate_psnr, calculate_ssim)
from super_resolution_tpu_torch.utils.registry import METRIC_REGISTRY

__all__ = ["calculate_metric", "calculate_psnr", "calculate_ssim",
           "METRIC_REGISTRY"]


def calculate_metric(data: dict, opt: dict):
    """Dispatch on opt['type'] through the metric registry."""
    opt = deepcopy(opt)
    metric_type = opt.pop("type")
    return METRIC_REGISTRY.get(metric_type)(**data, **opt)
