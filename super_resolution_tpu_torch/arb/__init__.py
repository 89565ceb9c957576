"""Arbitrary-scale SR (port of super_resolution_tpu/arb/): the LIIF, LTE,
MetaSR and LTE+ heads over seven feature encoders, built from spec dicts by
``make``; the implicit datasets; ``eval_arb`` and ``train_arb``."""

from super_resolution_tpu_torch.arb.models import (  # noqa: F401
    LIIF, LTE, LTEP, MLP, MetaSR, make, make_coord, register,
    to_pixel_samples)
from super_resolution_tpu_torch.arb import encoders  # noqa: F401 registry
from super_resolution_tpu_torch.arb import data  # noqa: F401 registry
from super_resolution_tpu_torch.arb.eval import (  # noqa: F401
    arb_psnr, batched_predict, eval_arb)
