"""Data parallelism of every training runner of the port on two gloo ranks
of the CPU: ``setup_training(mesh)`` over a (data: 2) mesh and one
iteration, each rank on its half of the batch, for ``ESRModel``, the
paired GAN runner (``SRGANModel``), ``HiFaceGANModel``, ``StyleGAN2Model``
(iteration 2: R1 and the path penalty fire, each rank on its own draws)
and ``EDVRModel``. After it G, D and the EMA are equal on both ranks, bit
for bit, and equal the runner's one-process iteration on the whole batch
(StyleGAN2Model: with the ranks' draws concatenated): a gradient summed
instead of averaged, a loss over the wrong share or a step on half the
batch shows there. ``ESRModel``'s step is also held against JAX's with the
batch sharded over a 2-device 'data' mesh; the other runners' one-process
iterations are held against JAX's in their own test files, and
``SRModel``'s data-parallel step in ``test_torch_parallel_dp.py``."""

import numpy as np
import pytest
import torch

from test_torch_esr_model import _options as esr_options
from test_torch_face_models import HF_D, HF_G, MAX_FLIP_SHARE, _sg_opt
from test_torch_paired_gan import _options as gan_options
from test_torch_video_models import EDVR, _options as video_options
from test_torch_esr_model import NET as ESR_NET, _jax_runner
from torch_dist import run_ranks
from torch_threads import few_torch_threads  # noqa: F401
import torch_parallel_workers as workers


def _hifacegan_opt(vgg):
    return {"name": "hifacegan", "model_type": "HiFaceGANModel", "scale": 1,
            "is_train": True, "manual_seed": 0, "num_gpu": 1,
            "network_g": dict(HF_G), "network_d": dict(HF_D),
            "path": {"pretrain_network_g": None},
            "train": {
                "optim_g": {"type": "Adam", "lr": 1e-3},
                "optim_d": {"type": "Adam", "lr": 1e-3},
                "scheduler": {"type": "MultiStepLR", "milestones": [100],
                              "gamma": 0.5},
                "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0},
                "perceptual_opt": {
                    "type": "PerceptualLoss", "vgg_weights_path": vgg,
                    "layer_weights": {"conv2_2": 1}, "vgg_type": "vgg19",
                    "use_input_norm": True, "perceptual_weight": 1.0,
                    "style_weight": 0, "range_norm": True,
                    "criterion": "l1"},
                "gan_opt": {"type": "MultiScaleGANLoss", "gan_type": "hinge",
                            "loss_weight": 1.0},
                "feature_matching_opt": {"type": "GANFeatLoss",
                                         "loss_weight": 10.0},
                "net_d_iters": 1, "net_d_init_iters": 0}}


WORLD = 2
NAMES = ["esr", "srgan", "hifacegan", "stylegan2", "edvr"]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    from super_resolution_tpu_torch.models.vgg_arch import \
        seeded_vgg19_state_dict

    root = tmp_path_factory.mktemp("runners")
    vgg = str(root / "vgg19.pth")
    torch.save(seeded_vgg19_state_dict(0), vgg)
    rng = np.random.default_rng(2)

    def img(*shape):
        return rng.random(shape, dtype=np.float32)

    cases = {
        "esr": dict(opt=esr_options(), iter=1,
                    batch={"lq": img(4, 16, 16, 3), "gt": img(4, 32, 32, 3)}),
        "srgan": dict(opt=gan_options("SRGANModel", vgg), iter=1,
                      batch={"lq": img(2, 32, 32, 3),
                             "gt": img(2, 128, 128, 3)}),
        "hifacegan": dict(opt=_hifacegan_opt(vgg), iter=1,
                          batch={"lq": img(2, 64, 64, 3),
                                 "gt": img(2, 64, 64, 3)}),
        # one code a part: a rank's mixing draw and inject index cannot be
        # those of the one-process batch the ranks are held against; 4
        # images a rank, D's minibatch-stddev group (see _interleave)
        "stylegan2": dict(opt=_sg_opt(mixing_prob=0.0), iter=2,
                          batch={"gt": img(8, 16, 16, 3) * 2 - 1},
                          interleave=True),
        "edvr": dict(opt=video_options("EDVRModel", EDVR), iter=1,
                     batch={"lq": img(2, 5, 16, 16, 3),
                            "gt": img(2, 64, 64, 3)}),
    }
    return cases, run_ranks(workers.runners_dp, WORLD, root,
                            {"cases": cases})


def _merge(parts, interleave: bool):
    """The ranks' shares (draws, or a batch) as the whole batch's: tensors
    joined along the batch dim in rank order, or interleaved (item i of
    rank r at i * ranks + r), the rest equal on every rank.

    Interleaving: StyleGAN2's D groups the batch for its minibatch stddev
    by index modulo batch / 4; a rank of 4 images forms one group, and the
    interleaved whole batch of 8 forms the same two groups, so that D sees
    the same statistic as on the ranks (each rank's own, as DDP gives)."""
    first = parts[0]
    if isinstance(first, dict):
        return {k: _merge([p[k] for p in parts], interleave) for k in first}
    if isinstance(first, list):
        return [_merge(list(t), interleave) for t in zip(*parts)]
    if isinstance(first, (torch.Tensor, np.ndarray)):
        ts = [torch.as_tensor(p) for p in parts]
        if not interleave:
            return torch.cat(ts)
        return torch.stack(ts, 1).reshape(-1, *ts[0].shape[1:])
    assert all(p == first for p in parts), parts
    return first


def _rank_shares(batch: dict) -> list:
    """The global batch's equal contiguous shares, one a rank (what
    ``shard_batch`` hands each rank)."""
    return [{k: v[r * (len(v) // WORLD):(r + 1) * (len(v) // WORLD)]
             for k, v in batch.items()} for r in range(WORLD)]


@pytest.fixture(scope="module")
def one_process(spawned):
    """Each runner's one-process iteration on the whole batch (the ranks'
    shares merged), with the ranks' draws."""
    from super_resolution_tpu_torch.runtime import build_model

    cases, ranks = spawned
    out = {}
    for name, case in cases.items():
        inter = case.get("interleave", False)
        batch = _merge(_rank_shares(case["batch"]), inter)
        model = build_model(dict(case["opt"]), "cpu")
        model.setup_training()
        if ranks[0][name]["draws"] is None:
            model.optimize_parameters(batch, case["iter"])
        else:
            model.feed_data(batch)
            model.train_iteration(
                _merge([r[name]["draws"] for r in ranks], inter),
                case["iter"])
        out[name] = {"nets": workers.runner_nets(model),
                     "grads": workers.runner_grads(model),
                     "lr": float(case["opt"]["train"]["optim_g"]["lr"]),
                     "extra": float(getattr(model, "mean_path_length", 0.0))}
    return out


@pytest.fixture(scope="module")
def ranks(spawned):
    return spawned[1]


@pytest.mark.parametrize("name", NAMES)
def test_runner_data_parallel_keeps_replicas_equal(ranks, name):
    a, b = ranks[0][name], ranks[1][name]
    assert a["moved"] and b["moved"]
    assert a["nets"].keys() == b["nets"].keys()
    for net in a["nets"]:
        for k, v in a["nets"][net].items():
            np.testing.assert_array_equal(v, b["nets"][net][k],
                                          err_msg=f"{name} {net} {k}")
    assert a["extra"] == b["extra"]


@pytest.mark.parametrize("name", NAMES)
def test_runner_data_parallel_matches_one_process(ranks, one_process, name):
    """Every rank's G and D gradients of the data-parallel iteration (their
    last updates') equal the one-process iteration's on the whole batch, to
    1e-5 of the network's largest gradient: a sum instead of a mean, or a
    loss over the wrong share, is off by a factor. The weights and EMA
    after the updates agree to lr / 10 but for at most 0.5 % of a
    network's entries, none off by more than 4 lr: Adam's first steps are
    lr * g / (|g| + eps), and where g is near eps (HiFaceGAN's conv biases
    before a parameter-free instance norm have a zero gradient in exact
    arithmetic) float rounding moves the step by a share of lr.
    StyleGAN2Model's running path length is the whole batch's."""
    want = one_process[name]
    lr = want["lr"]
    for r in ranks:
        got = r[name]
        assert got["grads"].keys() == want["grads"].keys()
        for net, gs in want["grads"].items():
            assert got["grads"][net].keys() == gs.keys()
            scale = max(float(np.abs(v).max()) for v in gs.values())
            for k, v in gs.items():
                np.testing.assert_allclose(got["grads"][net][k], v, rtol=0,
                                           atol=1e-5 * scale,
                                           err_msg=f"{name} {net} {k}")
        assert got["nets"].keys() == want["nets"].keys()
        for net, sd in want["nets"].items():
            assert got["nets"][net].keys() == sd.keys()
            d = np.concatenate([np.abs(got["nets"][net][k] - v).ravel()
                                for k, v in sd.items()
                                if np.issubdtype(v.dtype, np.floating)])
            assert d.max() <= 4 * lr, (net, d.max())
            assert (d > lr / 10).mean() <= MAX_FLIP_SHARE, (
                net, (d > lr / 10).mean())
        assert got["extra"] == pytest.approx(want["extra"], rel=1e-6)


def _esr_flax_template():
    """Zeros of the JAX ESC's param tree (shapes from ``jax.eval_shape``)."""
    import jax
    import jax.numpy as jnp

    from super_resolution_tpu.models import build_network as j_build

    shapes = jax.eval_shape(lambda: j_build(ESR_NET).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))["params"])
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                  shapes)


def test_esr_data_parallel_matches_jax_data_sharded(spawned, monkeypatch):
    """ESRModel's data-parallel step against JAX's ESRModel with the batch
    sharded over a 2-device 'data' mesh (its ``feed_data`` puts the batch
    dim on the mesh), from the same weights."""
    import jax
    from jax.sharding import Mesh

    from super_resolution_tpu.convert.torch_import import convert_state_dict
    from super_resolution_tpu_torch.convert.flax_bridge import \
        flax_to_state_dict
    from super_resolution_tpu_torch.runtime import build_model

    cases, ranks = spawned
    case = cases["esr"]
    port = build_model(dict(case["opt"]), "cpu")
    init = {k: v.numpy() for k, v in port.net_g.state_dict().items()}
    model = _jax_runner(dict(case["opt"]),
                        convert_state_dict(init, _esr_flax_template(),
                                           strict=True), monkeypatch)
    model.mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("data",))
    model.optimize_parameters(case["batch"], case["iter"])
    ref = flax_to_state_dict(jax.device_get(model.state.params), port.net_g)
    diffs = np.concatenate([np.abs(ranks[0]["esr"]["nets"]["g"][k]
                                   - v.float().numpy()).ravel()
                            for k, v in ref.items()])
    lr = case["opt"]["train"]["optim_g"]["lr"]
    assert diffs.max() <= lr / 10 and diffs.mean() <= 1e-7, (
        diffs.max(), diffs.mean())
