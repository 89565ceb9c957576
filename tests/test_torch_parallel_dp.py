"""Data parallelism and the evaluation mesh of the port on two gloo ranks of
the CPU (``parallel/mesh.py``, ``SRModel.setup_training(mesh)``,
``dist_validation``, ``tile: {multichip: true}``, ``bucketed_tile_eval(
mesh=)``):

- one DP step, each rank on its half of a batch of 4, against the
  one-process step on the whole batch (parameters and EMA to 2e-6) and
  against JAX's step with the batch sharded over a 2-device 'data' mesh
  (``convert_state_dict``'s weights; parameters to lr / 10 at worst and
  1e-7 on average, as ``test_torch_train_step.py`` holds one process);
- process-sharded validation against whole-set validation (PSNR to 1e-9);
- multi-rank tiled and bucketed evaluation against one process (exact:
  the same tiles through the same network);
- the loader's per-rank split (JAX ``EnlargedSampler``'s partition) and the
  ``mesh:`` block's sizes and warning (JAX ``make_mesh_from_spec``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from test_torch_train_pipeline import _options, pairs  # noqa: F401
from torch_dist import run_ranks
from torch_threads import few_torch_threads  # noqa: F401
import torch_parallel_workers as workers

WORLD = 2
LR = 1e-3
TILE = {"tile_size": 8, "tile_pad": 4, "chunk": 3}


def _opt():
    return {"name": "dp", "model_type": "HATModel", "scale": 2,
            "manual_seed": 11, "path": {}, "is_train": False,
            "network_g": dict(type="HATClassic", img_size=16, embed_dim=24,
                              depths=[1], num_heads=[2], window_size=8,
                              compress_ratio=3, squeeze_factor=6,
                              conv_scale=0.01, overlap_ratio=0.5,
                              mlp_ratio=2.0, upscale=2,
                              upsampler="pixelshuffle",
                              drop_path_rate=0.0),
            "train": {"optim_g": {"type": "Adam", "lr": LR,
                                  "betas": [0.9, 0.99]},
                      "scheduler": {"type": "MultiStepLR",
                                    "milestones": [10], "gamma": 0.5},
                      "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0,
                                    "reduction": "mean"},
                      "ema_decay": 0.9, "warmup_iter": -1},
            "val": {"metrics": {"psnr": {"type": "calculate_psnr",
                                         "crop_border": 2}}}}


def _payload():
    rng = np.random.default_rng(9)
    gt = rng.random((4, 32, 32, 3)).astype(np.float32)
    lq = gt.reshape(4, 16, 2, 16, 2, 3).mean(axis=(2, 4))
    val = []
    for i, (h, w) in enumerate([(20, 28), (16, 16), (24, 20)]):
        g = rng.random((2 * h, 2 * w, 3)).astype(np.float32)
        val.append({"lq": g.reshape(h, 2, w, 2, 3).mean(axis=(1, 3)),
                    "gt": g, "lq_path": f"im{i}.png"})
    return {"opt": _opt(), "lq": lq, "gt": gt, "val": val, "tile": TILE}


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    p = _payload()
    ranks = run_ranks(workers.dp_runner, WORLD, tmp_path_factory.mktemp("dp"),
                      p)
    model = workers._sr_model(_opt())
    init = {k: v.clone() for k, v in model.net_g.state_dict().items()}
    model.setup_training()
    model.optimize_parameters({"lq": p["lq"], "gt": p["gt"]}, 1)
    return ranks, model, init, p


def test_dp_step_matches_one_process(dp):
    ranks, model, _, _ = dp
    for name, want in (("params", model.net_g.state_dict()),
                       ("ema", model.state.ema.state_dict())):
        for k, v in want.items():
            for r in ranks:
                np.testing.assert_allclose(r[name][k], v.numpy(), atol=2e-6,
                                           err_msg=f"{name} {k}")
    # the logged loss is the mean over the ranks: the global batch's
    assert ranks[0]["log"]["l_pix"] == pytest.approx(
        float(model.log_dict["l_pix"]), rel=1e-5)


def test_dp_step_matches_jax_data_sharded(dp):
    from super_resolution_tpu.convert.torch_import import convert_state_dict
    from super_resolution_tpu.models import hat_classic_arch as jhc
    from super_resolution_tpu.runtime.train_loop import (build_optimizer,
                                                         init_train_state,
                                                         make_sr_train_step)
    from super_resolution_tpu_torch.convert.flax_bridge import \
        flax_to_state_dict

    ranks, model, init, p = dp
    train_opt = _opt()["train"]
    kw = {k: (tuple(v) if isinstance(v, list) else v)
          for k, v in _opt()["network_g"].items() if k != "type"}
    jnet = jhc.HATClassic(**kw)
    shapes = jax.eval_shape(lambda: jnet.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))["params"])
    params = convert_state_dict(
        {k: v.numpy() for k, v in init.items()},
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                               shapes), strict=True)
    tx, _ = build_optimizer(train_opt)
    state = init_train_state(jax.tree_util.tree_map(jnp.asarray, params), tx,
                             train_opt["ema_decay"])
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("data",))
    batch = {k: jax.device_put(jnp.asarray(p[k]), NamedSharding(mesh,
                                                                P("data")))
             for k in ("lq", "gt")}
    state, _ = jax.jit(make_sr_train_step(jnet, tx, train_opt))(
        state, batch, jax.random.PRNGKey(0))
    ref = flax_to_state_dict(jax.device_get(state.params), model.net_g)
    diffs = np.concatenate([np.abs(ranks[0]["params"][k]
                                   - v.float().numpy()).ravel()
                            for k, v in ref.items()])
    assert diffs.max() <= LR / 10 and diffs.mean() <= 1e-7, (
        diffs.max(), diffs.mean())


def test_dist_validation_matches_nondist(dp):
    ranks, _, _, _ = dp
    for r in ranks:
        assert r["dist_metrics"]["psnr"] == pytest.approx(
            r["nondist_metrics"]["psnr"], abs=1e-9)


def test_multirank_tiled_and_bucketed_eval(dp):
    """Each rank upscales its part of every chunk (3 tiles rounded to 4)
    and returns the whole image, equal to one process's."""
    from super_resolution_tpu_torch.runtime.batched_eval import \
        bucketed_tile_eval

    ranks, _, _, p = dp
    one = workers._sr_model(dict(_opt(), tile=dict(TILE)))
    one.feed_data({"lq": p["val"][0]["lq"][None]})
    one._run_inference()
    with torch.inference_mode():
        outs = bucketed_tile_eval(one._apply_fn(),
                                  [torch.from_numpy(v["lq"][None])
                                   for v in p["val"]], 2, TILE["tile_size"],
                                  TILE["tile_pad"], chunk=3)
    for r in ranks:
        np.testing.assert_allclose(r["tiled"], one.output.numpy(), atol=1e-6)
        for got, want in zip(r["bucketed"], outs):
            np.testing.assert_allclose(got, want.numpy(), atol=1e-6)


class _Mesh:
    """A stand-in for a (data: n) DeviceMesh at one rank."""

    def __init__(self, n, r):
        self.mesh_dim_names = ("data",)
        self.n, self.r = n, r

    def size(self, dim=None):
        return self.n

    def get_local_rank(self, axis):
        return self.r


def test_loader_rank_split_matches_jax():
    """Rank r's batches take JAX's EnlargedSampler indices of rank r of
    2; together the ranks cover the epoch once."""
    from super_resolution_tpu.data import EnlargedSampler as JSampler
    from super_resolution_tpu_torch.data import build_dataloader

    class Items:
        def __len__(self):
            return 10

        def __getitem__(self, i):
            return {"i": np.asarray([i])}

    opt = {"phase": "train", "batch_size_per_gpu": 2,
           "dataset_enlarge_ratio": 1}
    seen = []
    for r in range(WORLD):
        loader = build_dataloader(Items(), opt, seed=3, mesh=_Mesh(WORLD, r))
        got = np.concatenate([b["i"][:, 0] for b in loader.epoch_iter(0)])
        js = JSampler(10, WORLD, r)
        js.set_epoch(3)
        np.testing.assert_array_equal(got, js.indices()[:len(got)])
        assert len(loader) == 2
        seen.append(got)
    assert len(set(np.concatenate(seen).tolist())) == 8


@pytest.mark.parametrize("spec,sizes", [({"data": -1}, {"data": 8}),
                                        ({"data": 4, "model": -1},
                                         {"data": 4, "model": 2}),
                                        ({"data": 2}, {"data": 2})])
def test_mesh_spec_matches_jax(spec, sizes):
    import logging

    from super_resolution_tpu.parallel.mesh import make_mesh_from_spec
    from super_resolution_tpu_torch.parallel.mesh import resolve_mesh_spec
    from super_resolution_tpu_torch.utils.logger import get_root_logger

    assert dict(make_mesh_from_spec(spec).shape) == sizes
    warned = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda record: warned.append(record.getMessage())
    logger = get_root_logger()
    logger.addHandler(handler)
    try:
        assert resolve_mesh_spec(spec, 8) == sizes
    finally:
        logger.removeHandler(handler)
    assert any("sit idle" in m for m in warned) == (
        np.prod(list(sizes.values())) < 8)
    with pytest.raises(ValueError, match="only one axis may be -1"):
        resolve_mesh_spec({"data": -1, "model": -1}, 8)


def test_run_train_mesh_block_world_of_one(pairs, tmp_path, monkeypatch):
    """``mesh: {data: -1}`` in the options: run_train joins the process
    group through env:// (a gloo world of one here, as ``torchrun
    --nproc_per_node 1`` sets it up), builds the mesh and trains data
    parallel; the weights and EMA equal the run without a mesh."""
    import socket

    import torch.distributed as dist

    from super_resolution_tpu_torch.runtime.train_pipeline import run_train
    from super_resolution_tpu_torch.utils.options import process_options

    runs = {}
    for run in ("plain", "mesh"):
        opt = _options(pairs, tmp_path / run, val=False)
        if run == "mesh":
            opt["mesh"] = {"data": -1}
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            for k, v in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                             RANK="0", WORLD_SIZE="1").items():
                monkeypatch.setenv(k, v)
        try:
            model, last = run_train(process_options(opt, str(tmp_path),
                                                    is_train=True),
                                    device="cpu")
            if run == "mesh":
                assert dist.get_backend() == "gloo" and model.mesh is not None
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        assert last == opt["train"]["total_iter"]
        runs[run] = (model.net_g.state_dict(), model.state.ema.state_dict())
    for got, want in zip(runs["mesh"], runs["plain"]):
        for k, v in want.items():
            torch.testing.assert_close(got[k], v, rtol=1e-6, atol=1e-7)


def test_pad_and_shard_batch_match_jax():
    """pad_batch_to_multiple pads with copies of the last item as JAX's
    does; shard_batch gives rank r the r-th equal part (JAX's
    device-sharded batch seen from one process) and refuses a batch the
    axis does not divide."""
    from super_resolution_tpu.parallel.mesh import \
        pad_batch_to_multiple as j_pad
    from super_resolution_tpu_torch.parallel.mesh import (
        pad_batch_to_multiple, shard_batch)

    batch = {"lq": np.arange(5 * 2, dtype=np.float32).reshape(5, 2),
             "gt": torch.arange(5 * 3, dtype=torch.float32).reshape(5, 3)}
    padded, n = pad_batch_to_multiple(batch, 4)
    want, jn = j_pad({"lq": batch["lq"], "gt": batch["gt"].numpy()}, 4)
    assert n == jn == 5
    np.testing.assert_array_equal(padded["lq"], want["lq"])
    np.testing.assert_array_equal(padded["gt"].numpy(), want["gt"])
    assert pad_batch_to_multiple(batch, 5) == (batch, 5)
    parts = [shard_batch(padded, _Mesh(4, r)) for r in range(4)]
    np.testing.assert_array_equal(
        np.concatenate([p["lq"] for p in parts]), padded["lq"])
    assert parts[3]["gt"].shape == (2, 3)
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(batch, _Mesh(2, 0))
