"""Loss factory (port of super_resolution_tpu/losses/__init__.py; ref:
basicsr/losses/__init__.py:19-31)."""

from copy import deepcopy

from super_resolution_tpu_torch.losses import (  # noqa: F401 registry
    basic, gan, perceptual)
from super_resolution_tpu_torch.losses.basic import (  # noqa: F401
    CharbonnierLoss, L1Loss, MSELoss, WeightedTVLoss, charbonnier_loss,
    get_refined_artifact_map, l1_loss, mse_loss)
from super_resolution_tpu_torch.losses.gan import (  # noqa: F401
    GANFeatLoss, GANLoss, MultiScaleGANLoss, g_path_regularize,
    gradient_penalty_loss, r1_penalty)
from super_resolution_tpu_torch.losses.perceptual import (  # noqa: F401
    PerceptualLoss)
from super_resolution_tpu_torch.utils.registry import LOSS_REGISTRY


def build_loss(opt: dict):
    """The loss named by ``opt['type']``, the other keys its arguments."""
    opt = deepcopy(opt)
    return LOSS_REGISTRY.get(opt.pop("type"))(**opt)
