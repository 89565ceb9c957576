"""The port's arbitrary-scale encoders on the CPU against the JAX package's,
on the same weights (the flax bridge), at depth 1-2 and narrow widths, each
built through ``make`` by its registered name: ESC (window 32, head dim
16: the ``fused_attention`` route, row 10), EDSR under both names,
SwinIR (an unshifted and a shifted block: rows 1, 2 and 6), RDN (config
A), RCAN, ATD-light (row 12) and HiT-SRF (row 14). On the CPU every kernel
wrapper runs its plain version. Inputs whose sides are no window multiple
exercise SwinIR's reflect pad and ATD's symmetric pad and their crops.

Tolerances: float32 on both sides, summation order only: 3e-5 on features
of a few units. ATD's sort is discrete: its inputs are drawn until no
pixel's two largest similarities are within 2e-5 (``_robust`` of
``tests/test_torch_atd.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from super_resolution_tpu.arb import models as jmodels
from super_resolution_tpu_torch import arb
from super_resolution_tpu_torch.models import atd_arch as tatd
from flax_weights import bridge
from test_torch_atd import _robust
from torch_threads import few_torch_threads  # noqa: F401

ATOL = 3e-5
# name -> (args, LR input size)
ENCODERS = {
    "esc": (dict(dim=32, pdim=8, kernel_size=5, n_blocks=1, conv_blocks=1,
                 window_size=32, num_heads=2, exp_ratio=1.25), (20, 24)),
    "edsr": (dict(n_resblocks=2, n_feats=8), (12, 15)),
    "edsr-baseline": (dict(n_resblocks=1, n_feats=8, res_scale=0.5),
                      (12, 15)),
    "swinir": (dict(embed_dim=12, depths=(2,), num_heads=(2,),
                    window_size=8, mlp_ratio=2.0), (13, 18)),
    "rdn": (dict(G0=8, RDNconfig="A"), (10, 12)),
    "rcan": (dict(n_resgroups=2, n_resblocks=2, n_feats=8, reduction=4),
             (12, 14)),
    "ATDLight": (dict(embed_dim=16, depths=(2,), num_heads=(2,),
                      window_size=8, category_size=32, num_tokens=8,
                      reducted_dim=4, convffn_kernel_size=3, mlp_ratio=1.0),
                 (13, 18)),
    "HiTSRF": (dict(embed_dim=20, depths=(2,), num_heads=(2,),
                    base_win_size=(4, 4), mlp_ratio=2.0,
                    hier_win_ratios=(0.5, 1)), (16, 24)),
}
# the port's wrapper each encoder's blocks call, and how often a forward on
# the CPU (ATD's layers take their windowed plain path there:
# test_atd_encoder_routes_like_the_card)
CALLS = {"esc": {"fused_attention": 1},
         "swinir": {"fused_msa_block": 1, "fused_msa_block_shifted": 1,
                    "mlp_block": 2},
         "HiTSRF": {"fused_scc_block": 2}}


def _wrapper_calls(monkeypatch):
    """Count each kernel wrapper's calls (on a CPU tensor: its plain
    version), patched in its own module, where the ``*_ad`` entries look it
    up."""
    from super_resolution_tpu_torch.ops import (cuda_attention, cuda_ffn,
                                                cuda_scc,
                                                cuda_window_attention)

    calls = {}
    for mod, name in ((cuda_window_attention, "fused_attention"),
                      (cuda_attention, "fused_msa_block"),
                      (cuda_attention, "fused_msa_block_shifted"),
                      (cuda_ffn, "mlp_block"),
                      (cuda_window_attention, "fused_msa_attention"),
                      (cuda_scc, "fused_scc_block")):
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.mark.parametrize("name", list(ENCODERS))
def test_encoder_matches_jax(name, rng, monkeypatch):
    args, (h, w) = ENCODERS[name]
    spec = {"name": name, "args": args}
    jmod, tmod = jmodels.make(spec), arb.make(spec)
    assert tmod.out_dim == jmod.out_dim
    params = bridge(jmod, tmod, rng, np.zeros((1, h, w, 3), np.float32))
    tmod.eval()

    def draw():
        return (rng.random((2, h, w, 3), dtype=np.float32),)
    if name == "ATDLight":
        x, = _robust(tmod, draw, lambda a: tmod(torch.from_numpy(a)))
    else:
        x, = draw()
    ref = np.asarray(jax.jit(jmod.apply)({"params": params}, jnp.asarray(x)))
    calls = _wrapper_calls(monkeypatch)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, h, w, jmod.out_dim)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    assert calls == CALLS.get(name, {})


def test_rcan_refuses_an_upsampling_trunk():
    with pytest.raises(ValueError, match="no_upsampling"):
        arb.make({"name": "rcan", "args": {"no_upsampling": False}})


def test_atd_encoder_routes_like_the_card(rng, monkeypatch):
    """With the card's route (``use_kernel`` patched), ATD's layers call
    ``fused_msa_attention_ad``; its plain version on the CPU tensor gives
    the windowed path's result."""
    args, (h, w) = ENCODERS["ATDLight"]
    tmod = arb.make({"name": "ATDLight", "args": args}).eval()
    x = torch.from_numpy(rng.random((1, h, w, 3), dtype=np.float32))
    with torch.no_grad():
        ref = tmod(x)
    seen = []
    fn = tatd.fused_msa_attention_ad
    monkeypatch.setattr(tatd, "use_kernel", lambda t: True)
    monkeypatch.setattr(tatd, "fused_msa_attention_ad", lambda *a, **kw: (
        seen.append(a[2] is None), fn(*a, **kw))[1])
    with torch.no_grad():
        got = tmod(x)
    assert seen == [True, False]
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)
