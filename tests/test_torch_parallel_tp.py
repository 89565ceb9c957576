"""Tensor parallelism of the port (``super_resolution_tpu_torch/parallel/
tp*.py``) on two gloo ranks of the CPU, against JAX's
``parallel/tp_attention.py`` and ``tp_ffn.py`` on the 8-device CPU mesh
(data 2 x model 4) on the same inputs:

- the four head- and hidden-parallel functions (and the shifted forms of
  rows 2 and 4: JAX's on the rolled input, and with the attention rolled
  back), output and the gradient of sum(out ** 2) for every input, to 1e-5;
- JAX's refusals (heads or hidden dim that P does not divide);
- the route gate: under ``tp_attention`` a fused route takes its plain path
  except inside a TP route's own kernel call;
- a Megatron MLP held as DTensor shards (``shard_params_tp``) against the
  replicated one;
- a tiny HATClassic under ``tp_attention`` (split and ``fused_hab_block``
  routes) against its one-process forward, and one TP train step of
  ``SRModel.setup_training`` against the one-process step;
- the Megatron rules over the port's state-dict names against JAX's over
  the flax tree of the same network.

Every rank computes the whole output; rank 0's is compared (rank 1's must
equal it)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from super_resolution_tpu_torch.ops.attention import shift_attn_mask
from torch_dist import run_ranks
from torch_threads import few_torch_threads  # noqa: F401
import torch_parallel_workers as workers

ATOL = 1e-5
WORLD = 2
SHIFT = 4


def _jax_mesh():
    return Mesh(np.asarray(jax.devices()).reshape(2, 4), ("data", "model"))


def _inputs():
    rng = np.random.default_rng(0)

    def mk(*s):
        return (rng.standard_normal(s) * 0.1).astype(np.float32)

    b, hw, c, heads, ws, ow, hid = 2, 16, 24, 4, 8, 12, 48
    n = ws * ws
    msa = dict(x=mk(b, hw, hw, c), w_qkv=mk(c, 3 * c), b_qkv=mk(3 * c),
               w_proj=mk(c, c), b_proj=mk(c), bias=mk(heads, n, n),
               mask0=np.zeros((1, n, n), np.float32),
               mask=shift_attn_mask(hw, hw, ws, SHIFT).astype(np.float32),
               heads=heads, ws=ws, shift=SHIFT)
    ocab = dict(x=mk(b, hw, hw, c), lns=1 + mk(c), lnb=mk(c), w_q=mk(c, c),
                b_q=mk(c), w_kv=mk(c, 2 * c), b_kv=mk(2 * c),
                w_proj=mk(c, c), b_proj=mk(c), bias=mk(heads, n, ow * ow),
                heads=heads, ws=ws, ow=ow)
    ffn = dict(x=mk(b, hw, hw, c), attn_rolled=mk(b, hw, hw, c),
               gamma=1 + mk(c), beta=mk(c), w1=mk(c, hid), b1=mk(hid),
               w2=mk(hid, c), b2=mk(c))
    return dict(msa=msa, ocab=ocab, ffn=ffn)


def _jax_value_and_grads(fn, args):
    args = tuple(jnp.asarray(a) for a in args)
    out = jax.jit(fn)(*args)
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(fn(*a) ** 2),
                             argnums=tuple(range(len(args)))))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _jax_results(p):
    from super_resolution_tpu.parallel.tp_attention import (
        head_parallel_msa_block, head_parallel_ocab_block)
    from super_resolution_tpu.parallel.tp_ffn import (
        hidden_parallel_mlp_block, hidden_parallel_mlp_sum3)

    mesh = _jax_mesh()
    m, o, f = p["msa"], p["ocab"], p["ffn"]
    kw = dict(heads=m["heads"], window_size=m["ws"], mesh=mesh)
    msa_args = [m[k] for k in ("x", "w_qkv", "b_qkv", "w_proj", "b_proj",
                               "bias")]
    tail = [f[k] for k in ("gamma", "beta", "w1", "b1", "w2", "b2")]

    def rolled(x):
        return jnp.roll(x, (-SHIFT, -SHIFT), (1, 2))

    res = {
        "msa": _jax_value_and_grads(
            lambda *a: head_parallel_msa_block(*a, jnp.asarray(m["mask0"]),
                                               **kw), msa_args),
        # JAX's shifted block: the head-parallel block on the rolled input
        "msa_shifted": _jax_value_and_grads(
            lambda x, *a: head_parallel_msa_block(
                rolled(x), *a, jnp.asarray(m["mask"]), **kw), msa_args),
        "ocab": _jax_value_and_grads(
            lambda *a: head_parallel_ocab_block(
                *a, heads=o["heads"], window_size=o["ws"],
                overlap_win=o["ow"], mesh=mesh),
            [o[k] for k in ("x", "lns", "lnb", "w_q", "b_q", "w_kv", "b_kv",
                            "w_proj", "b_proj", "bias")]),
        "mlp": _jax_value_and_grads(
            lambda *a: hidden_parallel_mlp_block(*a, mesh=mesh),
            [f["x"]] + tail),
        "sum3": _jax_value_and_grads(
            lambda *a: hidden_parallel_mlp_sum3(*a, conv_scale=0.01,
                                                mesh=mesh),
            [f["x"], f["x"] * 0.5, f["x"] * -0.25] + tail),
        # JAX's shifted tail: the attention rolled back, then sum3
        "sum3_shifted": _jax_value_and_grads(
            lambda s, a, *r: hidden_parallel_mlp_sum3(
                s, jnp.roll(a, (SHIFT, SHIFT), (1, 2)), *r, conv_scale=0.01,
                mesh=mesh),
            [f["x"], f["attn_rolled"], f["x"] * -0.25] + tail),
    }
    return res


FORK = dict(type="HAT", embed_dim=24, depths=[1], num_heads=[2],
            window_size=8, compress_ratio=3, squeeze_factor=6,
            conv_scale=0.01, overlap_ratio=0.5, mlp_ratio=2.0, upscale=2,
            esc_pdim=8, esc_kernel=5, ocab_esc_enable=True, ocab_esc_pdim=8,
            ocab_esc_kernel=5)


def _classic_payload():
    rng = np.random.default_rng(5)
    gt = rng.random((2, 32, 32, 3)).astype(np.float32)
    lq = gt.reshape(2, 16, 2, 16, 2, 3).mean(axis=(2, 4))
    return {"opt": _classic_opt(), "lq": lq, "gt": gt}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Both parts' ranks in one spawn (a spawn costs seconds)."""
    p = dict(_inputs(), fork=FORK, classic=_classic_payload())
    return p, run_ranks(workers.tp_all, WORLD,
                        tmp_path_factory.mktemp("tp"), p)


@pytest.fixture(scope="module")
def results(spawned):
    p, ranks = spawned
    return [r["functions"] for r in ranks], _jax_results(p)


CASES = ["msa", "msa_shifted", "ocab", "mlp", "sum3", "sum3_shifted"]


@pytest.mark.parametrize("case", CASES)
def test_forward_matches_jax(results, case):
    ranks, ref = results
    np.testing.assert_allclose(ranks[0][case]["out"], ref[case][0],
                               atol=ATOL)
    np.testing.assert_array_equal(ranks[0][case]["out"],
                                  ranks[1][case]["out"])


@pytest.mark.parametrize("case", CASES)
def test_grads_match_jax(results, case):
    """The gradient of every input on every rank is JAX's (the replicated
    weights' sums over the head groups included)."""
    ranks, ref = results
    for i, want in enumerate(ref[case][1]):
        scale = max(float(np.abs(want).max()), 1.0)
        for r in range(WORLD):
            np.testing.assert_allclose(
                ranks[r][case]["grads"][i] / scale, want / scale, atol=ATOL,
                err_msg=f"{case}: input {i}, rank {r}")


@pytest.mark.parametrize("case,match", [("heads", "3 heads do not divide"),
                                        ("hidden", "hidden dim 5 does not")])
def test_refusals(results, case, match):
    assert match in results[0][0]["refused"][case]


def test_tp_route_gate(results):
    """Under tp_attention a TP route is taken where the model axis (2)
    divides the heads or hidden dim (4) and not where it does not (3);
    after the context neither is."""
    assert results[0][0]["route"] == [True, True, False, False, False]


def test_fork_routes_launch_their_kernels_under_tp(results):
    """The fork's HAB and its ESC-infused OCAB attention have no TP
    composition: under tp_attention every rank calls their kernel
    wrappers on the whole replicated weights, its OCAB tail goes
    hidden-parallel (the wrapper on each rank's slice), and the output is
    the one-process call's."""
    for rank in results[0]:
        r = rank["plain_routes"]
        calls = {"ln_split": 1, "gated_dconv_ffn_block": 1,
                 "fused_ocab_attention": 1, "mlp_block": 1}
        assert r["plain"]["calls"] == calls
        assert r["tp"]["calls"] == calls
        np.testing.assert_allclose(r["tp"]["out"], r["plain"]["out"],
                                   atol=ATOL)


def test_dtensor_megatron_mlp(results):
    dt = results[0][0]["dtensor"]
    assert dt["plan"] == {"mlp.fc1": "colwise", "mlp.fc2": "rowwise"}
    assert set(dt["sharded"]) == {"DTensor"}
    assert dt["out_err"] < 1e-6 and dt["grad_err"] < 1e-5


# ---------------------------------------------------------------- HATClassic
def _classic_opt():
    return {"name": "tp", "model_type": "HATModel", "scale": 2,
            "manual_seed": 3, "path": {},
            "network_g": dict(type="HATClassic", img_size=16, embed_dim=24,
                              depths=[2], num_heads=[2], window_size=8,
                              compress_ratio=3, squeeze_factor=6,
                              conv_scale=0.01, overlap_ratio=0.5,
                              mlp_ratio=2.0, upscale=2,
                              upsampler="pixelshuffle"),
            "train": {"optim_g": {"type": "Adam", "lr": 1e-3,
                                  "betas": [0.9, 0.99]},
                      "scheduler": {"type": "MultiStepLR",
                                    "milestones": [10], "gamma": 0.5},
                      "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0},
                      "ema_decay": 0.9}}


@pytest.fixture(scope="module")
def classic(spawned):
    p, ranks = spawned
    lq, gt = p["classic"]["lq"], p["classic"]["gt"]
    model = workers._sr_model(_classic_opt())
    with torch.no_grad():
        ref = model.net_g(torch.from_numpy(lq)).numpy()
    model.setup_training()
    model.optimize_parameters({"lq": lq, "gt": gt}, 1)
    return [r["classic"] for r in ranks], ref, model


def test_hat_classic_tp_forward(classic):
    """Both routes match the one-process forward; every HAB and OCAB went
    head- and hidden-parallel, fused_hab_block yielding to the split
    route."""
    ranks, ref, _ = classic
    for r in ranks:
        np.testing.assert_allclose(r["out"], ref, atol=ATOL)
        np.testing.assert_allclose(r["out_fused"], ref, atol=ATOL)
    # 2 HABs and an OCAB in each of three forwards: the two routes and
    # the train step's, where the second HAB (drop-path rate 0.1) runs its
    # tail unfused
    calls = ranks[0]["calls"]
    assert calls["head_parallel_msa_block"] == 6
    assert calls["hidden_parallel_mlp_sum3"] == 5
    assert calls["head_parallel_ocab_block"] == 3
    assert calls["hidden_parallel_mlp_block"] == 3
    assert "fused_hab_block_ad" not in calls
    assert "fused_msa_block_ad" not in calls


def test_hat_classic_tp_train_step(classic):
    ranks, _, model = classic
    assert ranks[0]["head_par"] and ranks[0]["hid_par"]
    assert ranks[0]["loss"] == pytest.approx(
        float(model.log_dict["l_pix"]), rel=1e-5)
    for k, v in model.net_g.state_dict().items():
        for r in ranks:
            np.testing.assert_allclose(r["params"][k], v.numpy(), atol=2e-5,
                                       err_msg=k)


# --------------------------------------------------------------------- rules
def test_megatron_rules_match_jax():
    """The port's rules over state-dict names shard the same bytes as
    JAX's over the flax tree, and agree on the hidden-dim gate."""
    from super_resolution_tpu.models import hat_classic_arch as jhc
    from super_resolution_tpu.parallel import tp as jtp
    from super_resolution_tpu_torch.models import build_network
    from super_resolution_tpu_torch.parallel import tp

    net_opt = _classic_opt()["network_g"]
    kw = {k: (tuple(v) if isinstance(v, list) else v)
          for k, v in net_opt.items() if k != "type"}
    state = build_network(dict(net_opt)).state_dict()
    state = {k: v for k, v in state.items()
             if v.is_floating_point() and "relative_position_index" not in k}
    params = jax.eval_shape(lambda: jhc.HATClassic(**kw).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))["params"])
    params = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), params)
    assert tp.tp_sharded_fraction(state) == pytest.approx(
        jtp.tp_sharded_fraction(params), rel=1e-6)
    for ntp in (2, 5):
        assert (tp.mlp_hidden_divisible(state, ntp)
                == jtp.mlp_hidden_divisible(params, ntp))
    specs = tp.tp_param_specs(state)
    assert specs["layers.0.residual_group.blocks.0.attn.qkv.weight"] == 0
    assert specs["layers.0.residual_group.blocks.0.attn.proj.weight"] == 1
    assert specs["layers.0.residual_group.blocks.0.attn.proj.bias"] is None
    assert specs["layers.0.residual_group.overlap_attn.mlp.fc1.bias"] == 0
