"""The port's ``ESRModel`` training strategy against the JAX ``ESRModel`` on
the CPU, on JAX's own test net (ESC dim 16, pdim 8, kernel 5, one block of
one conv block, window 8, two heads, x2; bridged weights) and the same
batches, six steps a case: AdamW with weight decay under a warmup and a
milestone, Adam with a gradient clip that bites, the clip's halving past 50 000 updates, MESA
from its start ratio, momentum resets at a constant learning rate (where
both packages agree), and ``use_amp`` in bf16. Then the one deliberate
difference (the learning rate after a reset), the options that raise, and
a resumed run against the uninterrupted one.

Tolerances: float32, six updates at lr 1e-3: losses to 1e-5 relative,
weights and EMA as ``tests/test_torch_train_step.py`` holds them (lr / 10
at worst, 1e-7 on average: an Adam update divides the gradient by its
running RMS, so a weight whose gradient is near 0 moves by up to lr on
rounding noise). bf16: losses to 2e-2 relative; weights lr / 10 apart on
average and lr / 2 at the 99th percentile (5.2e-5 and 4.5e-4 measured
after six updates, which move them by 1.9e-3 on average; three updates
stay within lr / 20 in ``tests/test_torch_train_step.py``): a few weights
whose bf16 gradient is near 0 take opposite Adam steps. A resumed run
repeats the uninterrupted one's operations: equal."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from super_resolution_tpu_torch.convert.flax_bridge import flax_to_state_dict
from super_resolution_tpu_torch.runtime import build_model
from super_resolution_tpu_torch.runtime.esr_model import (CLIP_HALVING_STEP,
                                                          ESRModel)
from torch_threads import few_torch_threads  # noqa: F401

NET = {"type": "ESC", "dim": 16, "pdim": 8, "kernel_size": 5, "n_blocks": 1,
       "conv_blocks": 1, "window_size": 8, "num_heads": 2,
       "upscaling_factor": 2, "exp_ratio": 1.0}
LR = 1e-3
ATOL_PARAM = LR / 10
ATOL_PARAM_MEAN = 1e-7
RTOL_LOSS = 1e-5
STEPS = 6


def _options(use_amp=False, **train):
    opt = {
        "name": "esr", "model_type": "ESRModel", "scale": 2, "num_gpu": 1,
        "manual_seed": 0, "is_train": True, "use_amp": use_amp,
        "network_g": dict(NET), "datasets": {},
        "train": {
            "optim_g": {"type": "AdamW", "lr": LR, "betas": [0.9, 0.99],
                        "weight_decay": 0},
            "scheduler": {"type": "MultiStepLR", "milestones": [10 ** 6],
                          "gamma": 0.5},
            "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0,
                          "reduction": "mean"},
            "ema_decay": 0.9, "total_iter": 10, "warmup_iter": -1},
        "path": {"pretrain_network_g": None},
    }
    opt["train"]["optim_g"].update(train.pop("optim_g", {}))
    opt["train"].update(train)
    return opt


# Adam (weight decay 0) in every case but the first, which is AdamW
CASES = {
    "adamw_weight_decay_warmup": dict(
        optim_g={"weight_decay": 0.05}, warmup_iter=3, scheduler={
            "type": "MultiStepLR", "milestones": [4], "gamma": 0.5}),
    "clip": dict(gradient_clip=0.02),
    "clip_halved": dict(gradient_clip=0.02, start_step=CLIP_HALVING_STEP + 1),
    "mesa": dict(mesa_opt={"type": "L1Loss", "loss_weight": 0.5,
                           "reduction": "mean", "start_ratio": 0.3}),
    "momentum_reset": dict(reset_momentum_iter=2),
}


def _batches(n=STEPS, b=2, lq=16):
    rng = np.random.default_rng(42)
    out = []
    for _ in range(n):
        gt = rng.random((b, 2 * lq, 2 * lq, 3)).astype(np.float32)
        gt = 0.25 * (gt + np.roll(gt, 1, 1) + np.roll(gt, 1, 2)
                     + np.roll(gt, (1, 1), (1, 2)))
        out.append({"lq": gt.reshape(b, lq, 2, lq, 2, 3).mean(axis=(2, 4)),
                    "gt": gt})
    return out


@pytest.fixture(scope="module")
def weights():
    """The port's seeded initialisation with every all-zero tensor made
    random and the RPB widened (so each branch moves), and the same weights
    as the JAX ESC's param tree (its shapes from ``jax.eval_shape``)."""
    from super_resolution_tpu.convert.torch_import import convert_state_dict
    from super_resolution_tpu.models import build_network as j_build
    from super_resolution_tpu_torch.models import build_network
    from super_resolution_tpu_torch.models.arch_util import init_weights

    net = build_network(NET)
    init_weights(net, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    sd = {}
    for k, v in net.state_dict().items():
        if "relative_position_bias" in k:
            v = v * 500.0
        elif v.is_floating_point() and not v.any():
            v = torch.from_numpy((rng.standard_normal(tuple(v.shape))
                                  * 0.05).astype(np.float32))
        sd[k] = v
    shapes = jax.eval_shape(lambda: j_build(NET).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))["params"])
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    params = convert_state_dict({k: v.numpy() for k, v in sd.items()},
                                template, strict=True)
    return sd, params


def _jax_runner(opt, params, monkeypatch, start_step=0):
    from super_resolution_tpu.runtime import build_model as j_build_model
    from super_resolution_tpu.runtime import sr_model as j_sr_model
    from super_resolution_tpu.runtime.train_loop import TrainState

    # the bridged weights replace the flax init (which costs seconds)
    monkeypatch.setattr(j_sr_model.SRModel, "_init_params",
                        lambda self: None)
    model = j_build_model(opt)
    model.params = jax.tree_util.tree_map(jnp.asarray, params)
    model.setup_training()
    if start_step:
        s = model.state
        model.state = TrainState(step=jnp.asarray(start_step, jnp.int32),
                                 params=s.params, ema_params=s.ema_params,
                                 opt_state=s.opt_state)
    return model


def _port_runner(opt, sd, start_step=0):
    model = build_model(opt, "cpu")
    model.net_g.load_state_dict(sd, strict=True)
    model.setup_training()
    model.state.step = start_step
    return model


def _run(model, batches):
    """Each iteration's logs, through the runner's own methods."""
    logs = []
    for it, batch in enumerate(batches, start=1):
        model.optimize_parameters(batch, it)
        logs.append(model.get_current_log())
    return logs


def _param_diffs(net, flax_params):
    ref = flax_to_state_dict(jax.device_get(flax_params), net)
    got = net.state_dict()
    return torch.cat([(got[k].float() - ref[k].float()).abs().flatten()
                      for k in ref])


def _assert_params(net, flax_params):
    diffs = _param_diffs(net, flax_params)
    assert float(diffs.max()) <= ATOL_PARAM, float(diffs.max())
    assert float(diffs.mean()) <= ATOL_PARAM_MEAN, float(diffs.mean())


@pytest.mark.parametrize("case", list(CASES))
def test_six_steps_match_jax_esr_model(case, weights, monkeypatch):
    sd, params = weights
    train = dict(CASES[case])
    start = train.pop("start_step", 0)
    opt = _options(**train)
    batches = _batches()
    jmodel = _jax_runner(opt, params, monkeypatch, start)
    ref = _run(jmodel, batches)
    model = _port_runner(opt, sd, start)
    got = _run(model, batches)
    assert isinstance(model, ESRModel) and model.state.step == start + STEPS
    assert [sorted(g) for g in got] == [sorted(r) for r in ref]
    for key in got[0]:
        np.testing.assert_allclose([g[key] for g in got],
                                   [r[key] for r in ref], rtol=RTOL_LOSS,
                                   err_msg=key)
    _assert_params(model.net_g, jmodel.state.params)
    _assert_params(model.state.ema, jmodel.state.ema_params)
    moved = max(float((model.net_g.state_dict()[k] - v).abs().max())
                for k, v in sd.items() if v.is_floating_point())
    assert moved > 20 * ATOL_PARAM, moved
    if case == "mesa":
        # on from int(0.3 * 10) = iteration 3; logged as 0 before
        assert [g["l_mesa"] for g in got[:2]] == [0.0, 0.0]
        assert all(g["l_mesa"] > 0 for g in got[2:])


def test_amp_six_steps_match_jax_bf16(weights, monkeypatch):
    """Top-level ``use_amp``: bf16 casts of the float32 masters and of the
    LQ, the loss in float32, MESA's EMA forward in float32; the masters
    stay float32."""
    sd, params = weights
    opt = _options(use_amp=True, gradient_clip=0.5, mesa_opt={
        "type": "L1Loss", "loss_weight": 0.5, "reduction": "mean",
        "start_ratio": 0.3})
    batches = _batches()
    jmodel = _jax_runner(opt, params, monkeypatch)
    ref = _run(jmodel, batches)
    model = _port_runner(opt, sd)
    got = _run(model, batches)
    assert all(p.dtype == torch.float32 for p in model.net_g.parameters())
    for key in ("l_pix", "l_mesa"):
        np.testing.assert_allclose([g[key] for g in got],
                                   [r[key] for r in ref], rtol=2e-2,
                                   err_msg=key)
    f32 = _run(_port_runner(_options(), sd), batches[:1])
    # bf16, not float32: the first loss differs from the float32 one
    assert got[0]["l_pix"] != pytest.approx(f32[0]["l_pix"], rel=1e-5)
    diffs = _param_diffs(model.net_g, jmodel.state.params)
    assert float(diffs.mean()) <= LR / 10, float(diffs.mean())
    assert float(diffs.quantile(0.99)) <= LR / 2, float(diffs.quantile(0.99))


def test_momentum_reset_keeps_the_schedule_where_jax_restarts_it(
        weights, monkeypatch):
    """Under a warmup, resets every 2 iterations: the port's learning rate
    of update i is schedule(i), the update count; JAX re-initialises the
    whole optax state, so its schedule's count starts again at 0 (the
    deliberate difference of ROADMAP.md queue 3). Adam's own count starts
    again in both."""
    sd, params = weights
    opt = _options(warmup_iter=5, reset_momentum_iter=2)
    batches = _batches(3)
    jmodel = _jax_runner(opt, params, monkeypatch)
    model = _port_runner(opt, sd)
    lrs = []
    for it, batch in enumerate(batches, start=1):
        jmodel.optimize_parameters(batch, it)
        model.optimize_parameters(batch, it)
        lrs.append(model.state.optimizer.param_groups[0]["lr"])
    schedule = model.state.schedule
    assert lrs == [schedule(0), schedule(1), schedule(2)]
    assert schedule(2) > schedule(0) > 0
    # after the reset at iteration 2 and one update, JAX's schedule count
    # and Adam's count are both 1; the port's Adam count is 1 too
    counts = [int(c) for c in jax.tree_util.tree_leaves(
        jmodel.state.opt_state) if np.ndim(c) == 0]
    assert counts and all(c == 1 for c in counts), counts
    steps = [float(s["step"]) for s in model.state.optimizer.state.values()]
    assert steps and all(s == 1.0 for s in steps), steps
    assert model.state.step == 3


@pytest.mark.parametrize("key,loss,error,match", [
    ("wave_opt", {"type": "L1Loss"}, NotImplementedError, "wave_opt"),
    ("perceptual_opt", {"type": "PerceptualLoss",
                        "layer_weights": {"conv5_4": 1}}, ValueError,
     "vgg_weights_path")], ids=["wave_opt-loss0", "perceptual_opt-loss1"])
def test_unported_losses_raise(key, loss, error, match, weights):
    """``wave_opt`` raises, as in JAX; ``perceptual_opt`` is built (its
    step is ``tests/test_torch_esr_perceptual.py``'s), and one without VGG
    weights raises, as JAX's does: nothing is downloaded."""
    model = build_model(_options(**{key: loss}), "cpu")
    with pytest.raises(error, match=match):
        model.setup_training()


def test_resumed_run_equals_the_uninterrupted_one(weights, tmp_path):
    """Six iterations with a momentum reset every 2 and MESA from 3 (with a
    clip and weight decay), against three, a checkpoint, and a runner
    resumed from it for three more: the losses, the weights and the EMA
    bit for bit."""
    sd, _ = weights
    opt = _options(optim_g={"weight_decay": 0.02}, warmup_iter=4,
                   gradient_clip=0.05, reset_momentum_iter=2, mesa_opt={
                       "type": "L1Loss", "loss_weight": 0.5,
                       "reduction": "mean", "start_ratio": 0.4})
    opt["path"]["models"] = str(tmp_path / "models")
    batches = _batches()
    whole = _port_runner(opt, sd)
    ref = _run(whole, batches)
    first = _port_runner(opt, sd)
    got = _run(first, batches[:3])
    first.save(0, 3)
    resumed = _port_runner(opt, sd)
    assert resumed.resume_training(str(tmp_path / "models" / "net_g_3")) \
        == (0, 3)
    for it, batch in enumerate(batches[3:], start=4):
        resumed.optimize_parameters(batch, it)
        got.append(resumed.get_current_log())
    assert got == ref
    for a, b in ((whole.net_g, resumed.net_g),
                 (whole.state.ema, resumed.state.ema)):
        for (k, v), w in zip(a.state_dict().items(),
                             b.state_dict().values()):
            assert torch.equal(v, w), k
