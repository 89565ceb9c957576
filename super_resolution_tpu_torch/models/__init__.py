"""Architectures, built by their YAML ``type:`` name."""

from copy import deepcopy

from super_resolution_tpu_torch.models import (atd_arch,  # noqa: F401 registry
                                               esc_arch, hat_arch,
                                               hat_classic_arch,
                                               hitsrf_arch, srformer_arch)
from super_resolution_tpu_torch.utils.registry import ARCH_REGISTRY


def build_network(opt: dict):
    """Instantiate ``opt['type']`` with the remaining keys as arguments."""
    opt = deepcopy(opt)
    return ARCH_REGISTRY.get(opt.pop("type"))(**opt)
