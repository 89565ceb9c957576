"""Architectures, built by their YAML ``type:`` name."""

import inspect
from copy import deepcopy

from super_resolution_tpu_torch.models import (atd_arch,  # noqa: F401 registry
                                               basicvsr_arch,
                                               basicvsrpp_arch, cnn_archs,
                                               dfdnet_arch,
                                               discriminator_arch, duf_arch,
                                               ecbsr_arch, edvr_arch,
                                               esc_arch, esc_fp_arch,
                                               esc_real_arch, hat_arch,
                                               hat_classic_arch,
                                               hatx_arch, hifacegan_arch,
                                               hitsrf_arch,
                                               hybrid_hat_naf_arch,
                                               ridnet_arch, spynet_arch,
                                               srformer_arch,
                                               stylegan2_arch,
                                               stylegan2_bilinear_arch,
                                               swinir_arch, tof_arch)
from super_resolution_tpu_torch.utils.registry import ARCH_REGISTRY

# option keys of the reference's YAML files that change nothing here
# (training-time dropout, layers the networks do not have); a copy of the
# JAX package's list in super_resolution_tpu/models/__init__.py
IGNORED_KEYS = {"attn_drop_rate", "drop_rate", "qkv_bias", "qk_scale", "ape",
                "esc_use_dynamic", "patch_size"}


def build_network(opt: dict):
    """Instantiate ``opt['type']`` with the remaining keys as arguments,
    less :data:`IGNORED_KEYS` and ``use_checkpoint`` where the architecture
    does not take it; the reference's attention backends ``Naive``,
    ``SDPA`` and ``Flex`` become ``xla``, as in the JAX package."""
    opt = deepcopy(opt)
    cls = ARCH_REGISTRY.get(opt.pop("type"))
    kwargs = {k: v for k, v in opt.items() if k not in IGNORED_KEYS}
    if ("use_checkpoint" in kwargs and "use_checkpoint"
            not in inspect.signature(cls.__init__).parameters):
        del kwargs["use_checkpoint"]
    if kwargs.get("attn_type") in ("Naive", "SDPA", "Flex"):
        kwargs["attn_type"] = "xla"
    return cls(**kwargs)
