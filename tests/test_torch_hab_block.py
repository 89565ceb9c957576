"""The whole-block route of the port's classic HAT on the CPU
(``fused_hab_block`` on its plain version) against the JAX package:
``hab_block_reference`` against the JAX reference and the Pallas kernel in
interpret mode, ``HATClassic(hab_route="fused_hab_block")`` against the JAX
``HATClassic`` with and without its whole-block flag, the two routes of the
port against each other, the calls a forward makes, the card's predicate,
and the script that profiles a forward by the labels of the smoke test.

Tolerance 3e-5 absolute in float32 on both sides: summation order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from super_resolution_tpu.models.hat_classic_arch import HATClassic as JHAT
from super_resolution_tpu.ops import pallas_attention as pa
from super_resolution_tpu_torch.convert.flax_bridge import flax_to_state_dict
from super_resolution_tpu_torch.models import hat_classic_arch as thc
from super_resolution_tpu_torch.ops import cuda_hab_block as chb
from torch_threads import few_torch_threads  # noqa: F401

SMALL = dict(embed_dim=60, depths=(2, 2), num_heads=(2, 2), window_size=8,
             compress_ratio=3, squeeze_factor=6, conv_scale=0.01,
             overlap_ratio=0.5, mlp_ratio=2.0, upscale=4)
ATOL = 3e-5


def _hab_inputs(rng, b, h, w, c, heads, ws, hid):
    n = ws * ws

    def t(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    return (t(b, h, w, c), t(b, h, w, c), t(b, h, w, c), t(c, 3 * c, s=0.1),
            t(3 * c, s=0.1), t(c, c, s=0.1), t(c, s=0.1),
            t(heads, n, n, s=0.5), t(c), t(c), t(c, hid, s=0.1),
            t(hid, s=0.1), t(hid, c, s=0.1), t(c, s=0.1))


# (B, H, W, C, heads, ws, hidden): the JAX package's own case; head dim 30
# as at the flagship width on a 1 x 3 grid of windows
@pytest.mark.parametrize("shape", [(2, 16, 16, 12, 3, 8, 24),
                                   (1, 8, 24, 60, 2, 8, 120)])
def test_hab_block_reference_matches_jax(shape, rng):
    """The plain version against the JAX reference and against the Pallas
    kernel in interpret mode; the wrapper on a CPU tensor is the plain
    version and counts no launch."""
    b, h, w, c, heads, ws, hid = shape
    args = _hab_inputs(rng, *shape)
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(a) for a in args]
    got = chb.hab_block_reference(*targs, heads, ws, conv_scale=0.01).numpy()
    ref = np.asarray(pa.hab_block_reference(*jargs, heads, ws,
                                            conv_scale=0.01))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    kernel = np.asarray(pa.fused_hab_block(*jargs, heads=heads,
                                           window_size=ws, conv_scale=0.01,
                                           interpret=True))
    np.testing.assert_allclose(got, kernel, atol=ATOL, rtol=0)
    before = chb.fused_hab_block.launches
    wrapped = chb.fused_hab_block(*targs, heads=heads, window_size=ws,
                                  conv_scale=0.01)
    assert chb.fused_hab_block.launches == before
    np.testing.assert_array_equal(wrapped.numpy(), got)


def test_hab_block_supported_is_the_cards_predicate():
    """The flagship block (window 16, 180 channels in 6 heads, MLP 360)
    fits a block's shared memory, as do windows up to 23; window 24 and a
    head dim above 32 do not."""
    assert chb.hab_block_smem(16, 180, 6, 360) == 4 * (3 * 256 * 30
                                                       + 16 * 256) + 4 * 256
    assert chb.hab_block_supported(16, 180, 6, 360)
    assert chb.hab_block_supported(23, 180, 6, 360)
    assert not chb.hab_block_supported(24, 180, 6, 360)
    assert not chb.hab_block_supported(8, 180, 4, 360)      # head dim 45
    assert not chb.hab_block_supported(8, 180, 7, 360)      # 180 % 7
    # a small window: the MLP half is the larger
    assert chb.hab_block_smem(4, 60, 2, 120) == 4 * 32 * 240 + 4 * 16


def _jax_params(rng):
    net = JHAT(drop_path_rate=0.0, **SMALL)
    params = net.init(jax.random.PRNGKey(0),
                      jnp.zeros((1, 32, 32, 3)))["params"]

    def fix(path, v):
        v = np.asarray(v)
        if "relative_position_bias_table" in jax.tree_util.keystr(path):
            return v * 50.0
        if not v.any():
            return (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
        return v
    return net, jax.tree_util.tree_map_with_path(fix, jax.device_get(params))


def _port(params, **kw):
    model = thc.HATClassic(**SMALL, **kw).eval()
    model.load_state_dict(flax_to_state_dict(params, model), strict=True)
    return model


@pytest.mark.parametrize("mega", ["0", "1"], ids=["jax_split", "jax_mega"])
@pytest.mark.parametrize("route", thc.HAB_ROUTES)
def test_hat_classic_routes_match_jax(route, mega, rng, monkeypatch):
    """Either route of the port against the JAX model on its kernels in
    interpret mode, with its whole-block flag set and not."""
    monkeypatch.setenv("SR_TPU_ATTN", "pallas")
    monkeypatch.setenv("SR_TPU_FFN", "fused")
    monkeypatch.setenv("SR_TPU_HAB_MEGA", mega)
    net, params = _jax_params(rng)
    x = rng.random((1, 32, 32, 3), dtype=np.float32)
    ref = np.asarray(jax.jit(lambda p, t: net.apply({"params": p}, t))(
        params, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(params, hab_route=route)(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 128, 128, 3)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_the_two_routes_agree_and_call_their_kernels(rng, monkeypatch):
    """With the keyword each unshifted HAB calls ``fused_hab_block`` once
    and neither ``fused_msa_block`` nor ``mlp_block_sum3``; the shifted
    HABs and the OCAB keep their wrappers; the outputs agree."""
    _, params = _jax_params(rng)
    x = torch.from_numpy(rng.random((2, 16, 24, 3), dtype=np.float32))
    names = ("fused_hab_block_ad", "fused_msa_block_ad", "mlp_block_sum3_ad",
             "fused_msa_block_shifted_ad", "mlp_block_sum3_shifted_ad",
             "fused_ocab_block_ad", "mlp_block_ad")
    counts, outs = {}, {}
    for route in thc.HAB_ROUTES:
        calls = []
        with monkeypatch.context() as mp:
            for name in names:
                fn = getattr(thc, name)
                mp.setattr(thc, name, lambda *a, _f=fn, _n=name, **kw: (
                    calls.append(_n), _f(*a, **kw))[1])
            with torch.no_grad():
                outs[route] = _port(params, hab_route=route)(x).numpy()
        counts[route] = [calls.count(name) for name in names]
    assert counts["split"] == [0, 2, 2, 2, 2, 2, 2]
    assert counts["fused_hab_block"] == [2, 0, 0, 2, 2, 2, 2]
    np.testing.assert_allclose(outs["fused_hab_block"], outs["split"],
                               atol=ATOL, rtol=0)


def test_unknown_route_is_refused():
    with pytest.raises(ValueError, match="hab_route"):
        thc.HATClassic(**SMALL, hab_route="mega")


def test_predictor_takes_the_route_from_the_options(rng):
    """``hab_route`` in ``network_g`` reaches every HAB through the
    registry and the runner; the tiled output equals the split route's."""
    from super_resolution_tpu_torch.predict import Predictor

    opt = dict(name="hab_route_test", model_type="HATModel", scale=4,
               manual_seed=3, tile=dict(tile_size=16, tile_pad=8, chunk=2),
               network_g=dict(type="HATClassic", **SMALL))
    lq = rng.random((20, 27, 3), dtype=np.float32)
    split = Predictor(opt, device="cpu")
    opt["network_g"]["hab_route"] = "fused_hab_block"
    whole = Predictor(opt, device="cpu")
    blocks = whole.model.net_g.layers[1].residual_group.blocks
    assert [b.hab_route for b in blocks] == ["fused_hab_block"] * 2
    out = whole.predict_array(lq)
    assert out.shape == (80, 108, 3)
    np.testing.assert_allclose(out, split.predict_array(lq), atol=ATOL,
                               rtol=0)


def test_profile_forward_labels_are_the_smoke_tests_paths():
    """``tools/profile_forward.py`` takes the labels of
    ``chip_smoke.PATHS``, the two new paths among them, and names each
    kernel of the port's sources; no device is touched."""
    import pathlib
    import re

    import chip_smoke
    from super_resolution_tpu_torch.tools import profile_forward as pf

    assert pf.labels() == list(chip_smoke.PATHS)
    assert {"hitsrf", "classic_hab_block", "fork_hab_front", "swinir",
            "swinir_light", "swinir_real_l"} <= set(pf.labels())
    assert pf.classify("void (anonymous namespace)::scc_block_kernel"
                       "<__nv_bfloat16>(...)") == "scc_block_kernel"
    assert pf.classify("hab_block_kernel<float>") == "hab_block_kernel"
    csrc = pathlib.Path(chip_smoke.__file__).parent / chip_smoke._CSRC
    defined = set()
    for src in csrc.glob("*.cu"):
        defined |= set(re.findall(r"^\s+(\w+_kernel)\(", src.read_text(),
                                  re.M))
    assert defined == set(pf.PORT_KERNELS)
    for name, (mod, source, replaces) in chip_smoke.KERNELS.items():
        assert (csrc / source).exists(), source
        jax_file, line = replaces.split(":")
        text = (pathlib.Path(chip_smoke.__file__).parent / chip_smoke._POPS
                / jax_file).read_text().splitlines()
        assert "pallas_call" in text[int(line) - 1], (name, replaces)
