"""Runner factory."""

from copy import deepcopy

from super_resolution_tpu_torch.runtime import (  # noqa: F401 registry
    esr_model, hifacegan_model, realgan, sr_model, stylegan2_model,
    video_models)
from super_resolution_tpu_torch.utils.registry import MODEL_REGISTRY


def build_model(opt: dict, device="cuda"):
    """The runner named by ``opt['model_type']``, on ``device``."""
    return MODEL_REGISTRY.get(opt["model_type"])(deepcopy(opt), device)
