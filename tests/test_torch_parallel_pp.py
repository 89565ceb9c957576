"""Pipeline parallelism and row-sharded inference of the port
(``parallel/pipeline.py``, ``parallel/spatial.py``) on gloo ranks of the
CPU:

- ``pipeline_forward`` (GPipe, 2 microbatches) of HATClassic, the fork's
  HAT, SwinIR, SRFormer and ATD over a (pipe: 2) mesh against each
  network's plain forward (1e-5, as JAX's test_pipeline_parallel.py pins
  its own);
- one GPipe train step of ``SRModel.setup_training`` (pipe: 2), and one
  with tensor-parallel stages (pipe 2 x model 2, four ranks; JAX
  ``test_tp_pp_composed_train_step_matches_plain``), against the plain
  one-process step (1e-5);
- ``spatial_shard_forward`` of an exact-receptive-field CNN over two ranks
  against JAX's over the 8-device mesh on the same kernels, and the
  unsharded CNN; JAX's refusals;
- stacking, splitting and merging the stage parameters, and the refusal of
  unequal stages."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from torch_dist import run_ranks
from torch_threads import few_torch_threads  # noqa: F401
import torch_parallel_workers as workers

ATOL = 1e-5
BASE = dict(embed_dim=24, depths=[1, 1], num_heads=[2, 2], window_size=8,
            mlp_ratio=2.0, upscale=2)
HAT_KW = dict(compress_ratio=3, squeeze_factor=6, conv_scale=0.01,
              overlap_ratio=0.5, upsampler="pixelshuffle")
NETS = {
    "HATClassic": dict(BASE, type="HATClassic", **HAT_KW),
    "HAT": dict(BASE, type="HAT", esc_pdim=8, esc_kernel=5, **HAT_KW),
    "SwinIR": dict(BASE, type="SwinIR", upsampler="pixelshuffle"),
    "SRFormer": dict(BASE, type="SRFormer", img_size=16,
                     upsampler="pixelshuffle"),
    "ATD": dict(BASE, type="ATD", category_size=64, num_tokens=16,
                reducted_dim=4, convffn_kernel_size=5),
}


def _opt():
    return {"name": "pp", "model_type": "HATModel", "scale": 2,
            "manual_seed": 5, "path": {},
            "network_g": dict(NETS["HATClassic"], drop_path_rate=0.0),
            "train": {"optim_g": {"type": "Adam", "lr": 1e-3,
                                  "betas": [0.9, 0.99]},
                      "scheduler": {"type": "MultiStepLR",
                                    "milestones": [10], "gamma": 0.5},
                      "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0},
                      "ema_decay": 0.9}}


def _cnn_kernels(rng, c_in=3, c_mid=8, scale=2, k=5, n_layers=3):
    cs = [c_in] + [c_mid] * n_layers
    ks = [(rng.standard_normal((cs[i + 1], cs[i], k, k)) * 0.1)
          .astype(np.float32) for i in range(n_layers)]
    ks.append((rng.standard_normal((c_in * scale * scale, c_mid, 3, 3))
               * 0.1).astype(np.float32))
    return ks


def _jax_spatial(ks, img):
    from super_resolution_tpu.ops.conv import conv2d_nhwc
    from super_resolution_tpu.ops.pixelshuffle import pixel_shuffle
    from super_resolution_tpu.parallel.spatial import spatial_shard_forward

    kj = [jnp.asarray(k) for k in ks]

    def apply_fn(x):
        for k in kj[:-1]:
            x = jax.nn.leaky_relu(conv2d_nhwc(x, k))
        return pixel_shuffle(conv2d_nhwc(x, kj[-1]), 2)

    mesh = Mesh(np.array(jax.devices()), ("data",))
    return np.asarray(jax.jit(lambda im: spatial_shard_forward(
        apply_fn, im, 2, mesh, 8))(jnp.asarray(img)))


def _payload():
    rng = np.random.default_rng(4)
    gt = rng.random((2, 32, 32, 3)).astype(np.float32)
    return {"nets": NETS, "x": rng.random((2, 16, 16, 3)).astype(np.float32),
            "opt": _opt(), "gt": gt,
            "lq": gt.reshape(2, 16, 2, 16, 2, 3).mean(axis=(2, 4)),
            "cnn": _cnn_kernels(rng),
            "img": rng.standard_normal((1, 128, 24, 3)).astype(np.float32),
            "lq2": rng.random((2, 16, 16, 3)).astype(np.float32),
            "gt2": rng.random((2, 32, 32, 3)).astype(np.float32)}


def _plain_step(p):
    model = workers._sr_model(_opt())
    model.setup_training()
    model.optimize_parameters({"lq": p["lq"], "gt": p["gt"]}, 1)
    return model


@pytest.fixture(scope="module")
def pp(tmp_path_factory):
    p = _payload()
    root = tmp_path_factory.mktemp("pp")
    ranks = run_ranks(workers.pp_and_spatial, 2, root,
                      dict(p, ckpt=str(root / "models")))
    return ranks, p, _plain_step(p)


@pytest.mark.parametrize("name", list(NETS))
def test_pipeline_forward_matches_plain(pp, name):
    from super_resolution_tpu_torch.models import build_network
    from super_resolution_tpu_torch.models.arch_util import init_weights

    ranks, p, _ = pp
    net = build_network(dict(NETS[name]))
    init_weights(net, torch.Generator().manual_seed(0))
    with torch.no_grad():
        ref = net.eval()(torch.from_numpy(p["x"])).numpy()
    for r in ranks:
        np.testing.assert_allclose(r["forward"][name], ref, atol=ATOL)


def _assert_step(ranks, model):
    for r in ranks:
        assert r["loss"] == pytest.approx(float(model.log_dict["l_pix"]),
                                          rel=1e-5)
        for k, v in model.net_g.state_dict().items():
            np.testing.assert_allclose(r["params"][k], v.numpy(), atol=ATOL,
                                       err_msg=k)


def test_pp_train_step_matches_plain(pp):
    ranks, _, model = pp
    _assert_step(ranks, model)


def test_pp_resumed_run_equals_the_uninterrupted_one(pp):
    """A GPipe run checkpointed after step 1 and resumed on the same two
    pipe ranks takes step 2 as the run that went on: each pipe rank
    reloads its own optimizer moments (``opt_state_pp``). Without them
    Adam restarts and step 2 differs."""
    ranks, _, _ = pp
    for r in ranks:
        res = r["resume"]
        assert res["pipe_ranks_saved"] == 2
        for k, v in res["straight"].items():
            np.testing.assert_array_equal(res["resumed"][k], v, err_msg=k)
        assert max(float(np.abs(res["no_moments"][k] - v).max())
                   for k, v in res["straight"].items()) > 1e-4


def test_tp_pp_composed_train_step_matches_plain(pp, tmp_path):
    _, p, model = pp
    _assert_step(run_ranks(workers.tp_pp, 4, tmp_path, p), model)


def test_spatial_shard_matches_jax_and_unsharded(pp):
    ranks, p, _ = pp
    want = _jax_spatial(p["cnn"], p["img"])
    for r in ranks:
        assert r["spatial"].shape == (1, 256, 48, 3)
        np.testing.assert_allclose(r["spatial"], want, atol=ATOL, rtol=ATOL)
        np.testing.assert_allclose(r["spatial"], r["cnn"], atol=ATOL,
                                   rtol=ATOL)


def test_spatial_shard_refusals(pp):
    ranks, _, _ = pp
    assert "must divide" in ranks[0]["refused"][0]
    assert "2*halo" in ranks[0]["refused"][1]


def test_stage_params_round_trip():
    from super_resolution_tpu_torch.models import build_network
    from super_resolution_tpu_torch.parallel.pipeline import (
        merge_stage_params, pp_stage, split_stage_params)

    net = build_network(dict(NETS["HATClassic"]))
    state = net.state_dict()
    names, _ = pp_stage(net)
    stacked, rest = split_stage_params(state, names)
    assert all(v.shape[0] == 2 for v in stacked.values())
    merged = merge_stage_params(stacked, rest, names)
    assert merged.keys() == state.keys()
    assert all(torch.equal(merged[k], v) for k, v in state.items())
    unequal = build_network(dict(NETS["HATClassic"], num_heads=[2, 4]))
    with pytest.raises(ValueError, match="structurally identical"):
        pp_stage(unequal)
