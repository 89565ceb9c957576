"""The port's SR train step against JAX ``make_sr_train_step`` on the CPU, on
the same tiny fork HAT (bridged weights) and the same batches: the loss of
every step, then the parameters and the EMA, for Adam (also with the
ESC-infused OCAB of ``train_HAT_SRx2_from_scratch.yml``), Adam with weight
decay (decoupled, as optax.adamw), AdamW, SGD with momentum and a clipped
global norm; a ``use_amp`` run against JAX's bf16 run; and per-RHAG
``use_checkpoint`` against the same step without it, drop path included.

Tolerances: float32, five updates at lr 1e-3 (halved at update 3, so the
schedule's step count shows): losses to 1e-5 relative; parameters and EMA
to 1e-7 on average and lr / 10 at worst: an Adam update divides the
gradient by its running RMS, so a weight whose gradient is near 0 moves by
up to lr on rounding noise (one of conv_before_upsample's, 5e-5 apart).
bf16: both packages round activations and casts at their own points;
losses to 2e-2 relative (1e-3 measured), parameters lr / 20 apart on
average and lr / 2 at the 99th percentile (3e-5 and 3e-4 measured, where
three updates move them by 1.5e-3 on average); a few weights whose bf16
gradient is near 0 take opposite Adam steps. Remat and no remat run the
same operations: equal to 1e-6."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from super_resolution_tpu.models import hat_arch as jhat
from super_resolution_tpu_torch.convert.flax_bridge import flax_to_state_dict
from super_resolution_tpu_torch.models import hat_arch as that
from super_resolution_tpu_torch.runtime.train_loop import (init_train_state,
                                                           make_sr_train_step)
from torch_threads import few_torch_threads  # noqa: F401

TINY_KW = dict(img_size=16, embed_dim=24, depths=(1, 1), num_heads=(2, 2),
               window_size=8, compress_ratio=3, squeeze_factor=6,
               conv_scale=0.01, overlap_ratio=0.5, mlp_ratio=2.0,
               upscale=2, upsampler="pixelshuffle", drop_path_rate=0.0)
LR = 1e-3
ATOL_PARAM = LR / 10
ATOL_PARAM_MEAN = 1e-7
RTOL_LOSS = 1e-5


def _train_opt(**optim):
    opt = {"optim_g": {"type": "Adam", "lr": LR, "betas": [0.9, 0.99]},
           "scheduler": {"type": "MultiStepLR", "milestones": [3],
                         "gamma": 0.5},
           "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0,
                         "reduction": "mean"},
           "ema_decay": 0.9, "warmup_iter": -1}
    opt["optim_g"].update(optim.pop("optim_g", {}))
    opt.update(optim)
    return opt


OPTIMIZERS = {
    "adam": _train_opt(),
    # the fork's HAT x2 file's OCAB: ESC-infused, fused_ocab_attention
    "adam_ocab_esc": _train_opt(),
    "adam_weight_decay": _train_opt(optim_g={"weight_decay": 0.05}),
    "adamw": _train_opt(optim_g={"type": "AdamW", "weight_decay": 0.02}),
    "sgd": dict(_train_opt(), optim_g={"type": "SGD", "lr": 0.05,
                                       "momentum": 0.9}),
    "grad_clip": _train_opt(grad_clip_norm=0.02),
}


def _batches(n, b=2, lq=16):
    rng = np.random.default_rng(42)
    out = []
    for _ in range(n):
        gt = rng.random((b, 2 * lq, 2 * lq, 3)).astype(np.float32)
        gt = 0.25 * (gt + np.roll(gt, 1, 1) + np.roll(gt, 1, 2)
                     + np.roll(gt, (1, 1), (1, 2)))
        out.append((gt.reshape(b, lq, 2, lq, 2, 3).mean(axis=(2, 4)), gt))
    return out


def _weights(kw):
    """The port's seeded initialisation, every all-zero tensor made small
    and random (so each branch moves), and the same weights as the JAX
    HAT's param tree (its shapes from ``jax.eval_shape``: a flax init costs
    seconds)."""
    from super_resolution_tpu.convert.torch_import import convert_state_dict
    from super_resolution_tpu_torch.models.arch_util import init_weights

    net = that.HAT(**kw)
    init_weights(net, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    sd = {k: (v if v.any() or not v.is_floating_point() else
              torch.from_numpy((rng.standard_normal(tuple(v.shape)) * 0.05)
                               .astype(np.float32)))
          for k, v in net.state_dict().items()}
    shapes = jax.eval_shape(lambda: jhat.HAT(**kw).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))["params"])
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    params = convert_state_dict({k: v.numpy() for k, v in sd.items()},
                                template, strict=True)
    return sd, params


# the networks of OPTIMIZERS' cases that are not TINY_KW's
NETS = {"adam_ocab_esc": dict(TINY_KW, ocab_esc_enable=True, ocab_esc_pdim=8,
                              ocab_esc_kernel=5)}


@pytest.fixture(scope="module")
def weights():
    return _weights(TINY_KW)


def _pair(weights, kw=TINY_KW):
    """The JAX HAT with its params and the port's HAT on the same weights."""
    sd, params = weights
    tnet = that.HAT(**kw)
    tnet.load_state_dict(sd, strict=True)
    return jhat.HAT(**kw), params, tnet


def _run_jax(jnet, params, train_opt, batches):
    from super_resolution_tpu.runtime.train_loop import \
        build_optimizer as j_opt
    from super_resolution_tpu.runtime.train_loop import \
        init_train_state as j_init
    from super_resolution_tpu.runtime.train_loop import \
        make_sr_train_step as j_step

    tx, _ = j_opt(train_opt)
    state = j_init(jax.tree_util.tree_map(jnp.asarray, params), tx,
                   train_opt["ema_decay"])
    step = jax.jit(j_step(jnet, tx, train_opt))
    losses = []
    for lq, gt in batches:
        state, logs = step(state, {"lq": jnp.asarray(lq),
                                   "gt": jnp.asarray(gt)},
                           jax.random.PRNGKey(0))
        losses.append(float(logs["l_pix"]))
    return losses, jax.device_get(state.params), jax.device_get(
        state.ema_params)


def _run_port(tnet, train_opt, batches):
    state = init_train_state(tnet, train_opt)
    step = make_sr_train_step(train_opt)
    losses = []
    for lq, gt in batches:
        logs = step(state, {"lq": torch.from_numpy(lq),
                            "gt": torch.from_numpy(gt)}, torch.Generator())
        losses.append(float(logs["l_pix"]))
    assert state.step == len(batches)
    return losses, state


def _param_diffs(tnet_or_ema, flax_params):
    ref = flax_to_state_dict(flax_params, tnet_or_ema)
    got = tnet_or_ema.state_dict()
    return torch.cat([(got[k].float() - ref[k].float()).abs().flatten()
                      for k in ref])


def _assert_params(tnet_or_ema, flax_params, atol_max, atol_mean):
    diffs = _param_diffs(tnet_or_ema, flax_params)
    assert float(diffs.max()) <= atol_max, float(diffs.max())
    assert float(diffs.mean()) <= atol_mean, float(diffs.mean())


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_five_steps_match_jax(name, weights):
    train_opt = OPTIMIZERS[name]
    batches = _batches(5)
    kw = NETS.get(name, TINY_KW)
    jnet, params, tnet = _pair(weights if kw is TINY_KW else _weights(kw),
                               kw)
    ref_losses, ref_params, ref_ema = _run_jax(jnet, params, train_opt,
                                               batches)
    losses, state = _run_port(tnet, train_opt, batches)
    np.testing.assert_allclose(losses, ref_losses, rtol=RTOL_LOSS)
    _assert_params(tnet, ref_params, ATOL_PARAM, ATOL_PARAM_MEAN)
    _assert_params(state.ema, ref_ema, ATOL_PARAM, ATOL_PARAM_MEAN)
    # the parameters moved by far more than the tolerance
    moved = max(float((tnet.state_dict()[k] - v).abs().max()) for k, v in
                flax_to_state_dict(params, tnet).items())
    assert moved > 20 * ATOL_PARAM, moved


def test_amp_three_steps_match_jax_bf16(weights):
    """use_amp: bf16 casts of the float32 masters and of the input, the loss
    in float32; the masters stay float32."""
    train_opt = _train_opt(use_amp=True)
    batches = _batches(3)
    jnet, params, tnet = _pair(weights)
    ref_losses, ref_params, _ = _run_jax(jnet, params, train_opt, batches)
    with torch.no_grad():
        f32_loss = float((tnet(torch.from_numpy(batches[0][0]))
                          - torch.from_numpy(batches[0][1])).abs().mean())
    losses, state = _run_port(tnet, train_opt, batches)
    assert all(p.dtype == torch.float32 for p in tnet.parameters())
    np.testing.assert_allclose(losses, ref_losses, rtol=2e-2)
    # bf16, not float32: the first loss differs from the float32 one
    assert losses[0] != pytest.approx(f32_loss, rel=1e-5)
    diffs = _param_diffs(tnet, ref_params)
    assert float(diffs.mean()) <= LR / 20, float(diffs.mean())
    assert float(diffs.quantile(0.99)) <= LR / 2, float(diffs.quantile(0.99))


def _grads(net, lq, gt, seed, amp=False):
    train_opt = _train_opt(use_amp=amp)
    state = init_train_state(net, train_opt)
    for p in net.parameters():
        p.grad = None
    step = make_sr_train_step(train_opt)
    # lr 0: the step computes the gradients and leaves the weights
    state.schedule = lambda s: 0.0
    step(state, {"lq": lq, "gt": gt}, torch.Generator().manual_seed(seed))
    return {k: p.grad.clone() for k, p in net.named_parameters()}


@pytest.mark.parametrize("amp", [False, True])
def test_checkpoint_gives_the_same_gradients(amp):
    """Each RHAG under torch.utils.checkpoint, drop path at rate 0.5 (its
    draws made once, outside the checkpointed regions): the gradients of a
    step equal those without remat on the same generator seed; another
    seed gives others."""
    kw = dict(TINY_KW, depths=(2, 2), drop_path_rate=0.5)
    sd, _ = _weights(dict(kw, depths=(2, 2)))
    plain = that.HAT(**kw)
    plain.load_state_dict(sd)
    remat = that.HAT(**dict(kw, use_checkpoint=True))
    remat.load_state_dict(sd)
    lq, gt = (torch.from_numpy(a) for a in _batches(1)[0])
    ref = _grads(plain, lq, gt, seed=3, amp=amp)
    got = _grads(remat, lq, gt, seed=3, amp=amp)
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], rtol=1e-6, atol=1e-6,
                                   msg=k)
    other = _grads(plain, lq, gt, seed=4, amp=amp)
    assert any(not torch.equal(other[k], ref[k]) for k in ref)
