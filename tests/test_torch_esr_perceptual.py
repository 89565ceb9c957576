"""``ESRModel``'s step with ``perceptual_opt`` against the JAX ``ESRModel``
on the CPU, on ``tests/test_torch_esr_model.py``'s ESC and batches: the
VGG perceptual term beside the pixel loss, the perceptual and style terms
without a pixel loss, and the perceptual term under ``use_amp`` and under
MESA, three steps a case through the runners' own methods.

VGG19 is cut after conv2_2, its weights a seeded random state dict under
torchvision's names in a temporary .pth that both packages load.

Tolerances: float32: the losses to 1e-5 relative. Adam's first update is lr
times the sign of each gradient entry, so an entry whose gradient is
within rounding of 0 (at the kinks of the L1 losses, the VGG's ReLUs and
max-pools) moves by +lr in one package and -lr in the other: the weights
and the EMA within lr / 10 but for at most 0.5 % of the entries, each
within 2 lr a step (as ``tests/test_torch_realgan.py`` holds its
perceptual runs). bf16: the losses to 2e-2 relative, as the AMP case of
``tests/test_torch_esr_model.py``.
"""

import numpy as np
import pytest
import torch

import jax

from super_resolution_tpu_torch.convert.flax_bridge import flax_to_state_dict
from super_resolution_tpu_torch.models.vgg_arch import \
    seeded_vgg19_state_dict
from super_resolution_tpu_torch.runtime.esr_model import ESRModel
from test_torch_esr_model import (_batches, _jax_runner, _options,
                                  _port_runner, _run)
from test_torch_esr_model import weights  # noqa: F401 (a fixture)
from torch_threads import few_torch_threads  # noqa: F401

LR = 1e-3
STEPS = 3
RTOL_LOSS = 1e-5
ATOL_PARAM = LR / 10
MAX_FLIP_SHARE = 5e-3


@pytest.fixture(scope="module")
def vgg_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("vgg") / "vgg19.pth"
    torch.save(seeded_vgg19_state_dict(0), path)
    return str(path)


def _perceptual(vgg, style_weight=0.0):
    return {"type": "PerceptualLoss", "vgg_weights_path": vgg,
            "layer_weights": {"conv1_2": 0.1, "conv2_2": 1.0},
            "vgg_type": "vgg19", "use_input_norm": True,
            "perceptual_weight": 1.0, "style_weight": style_weight,
            "range_norm": False, "criterion": "l1"}


# case -> (use_amp, the train options beside perceptual_opt, the terms
# logged, its style weight)
CASES = {
    "pixel_and_perceptual": (False, {}, ["l_percep", "l_pix"], 0.0),
    "perceptual_and_style_only": (False, {"pixel_opt": None},
                                  ["l_percep", "l_style"], 50.0),
    "mesa": (False, {"mesa_opt": {"type": "L1Loss", "loss_weight": 0.5,
                                  "reduction": "mean",
                                  "start_ratio": 0.2}},
             ["l_mesa", "l_percep", "l_pix"], 0.0),
    "amp": (True, {}, ["l_percep", "l_pix"], 0.0),
}


def _assert_params(net, flax_params):
    ref = flax_to_state_dict(jax.device_get(flax_params), net)
    got = net.state_dict()
    d = torch.cat([(got[k].float() - ref[k].float()).abs().flatten()
                   for k in ref])
    share = float((d > ATOL_PARAM).float().mean())
    assert share <= MAX_FLIP_SHARE, share
    assert float(d.max()) <= 2 * LR * STEPS, float(d.max())


@pytest.mark.parametrize("case", list(CASES))
def test_perceptual_steps_match_jax(case, weights, vgg_path,  # noqa: F811
                                    monkeypatch):
    amp, train, terms, style = CASES[case]
    sd, params = weights
    opt = _options(use_amp=amp, **train,
                   perceptual_opt=_perceptual(vgg_path, style))
    batches = _batches(STEPS)
    jmodel = _jax_runner(opt, params, monkeypatch)
    ref = _run(jmodel, batches)
    model = _port_runner(opt, sd)
    got = _run(model, batches)
    assert isinstance(model, ESRModel) and model.state.step == STEPS
    assert [sorted(g) for g in got] == [sorted(r) for r in ref] == [
        terms] * STEPS
    rtol = 2e-2 if amp else RTOL_LOSS
    for key in terms:
        np.testing.assert_allclose([g[key] for g in got],
                                   [r[key] for r in ref], rtol=rtol,
                                   err_msg=key)
    if not amp:
        _assert_params(model.net_g, jmodel.state.params)
        _assert_params(model.state.ema, jmodel.state.ema_params)
    assert got[0]["l_percep"] > 0
    if case == "mesa":
        assert got[0]["l_mesa"] == 0.0 and got[-1]["l_mesa"] > 0
