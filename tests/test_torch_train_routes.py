"""Training on every kernel route, on the CPU against the JAX package: the
gradient entries of rows 3, 4, 13, 15, 16, 18 and the bare gated FFN
against ``jax.grad`` of the JAX ``*_ad`` functions (their forwards in
Pallas interpret mode); the drop path of the classic HAT (both
``hab_route``s), SwinIR and SRFormer block by block against JAX's route
choice, their train-mode outputs and input gradients at rate 0 against
JAX's ``deterministic=False``, and per-group remat against no remat; then
the first step of ``train.py``'s SR runner on each path the card trains
(the classic HAT on both routes, SRFormer, SwinIR, ESC on the forced
``msa_qtile_attention`` route, the fork's HAT on ``hab_front``) against
JAX's runner on the same weights and batch.

Small configs: embed 24 in 2 heads, 2 groups of 2 blocks, window 8, x2, on
16 x 16 LQ; the entries at (2, 16, 16, 24), hidden 48, window 8.

Tolerances: float32, summation order only: an entry's gradients 2e-5
absolute and 1e-4 relative (as ``tests/test_torch_train_parts.py`` holds
rows 5 to 8); a network's output and input gradient 3e-5 of their scale;
remat and no remat run the same operations: 1e-6. A runner's first loss to
1e-5 relative; its weights after the first update within lr / 10 but for
at most 0.5 % of the entries, each within 2 lr: Adam's first update is lr
times the sign of each gradient entry, so an entry whose gradient is
within rounding of 0 moves by +lr in one package and -lr in the other.
"""

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from super_resolution_tpu_torch.convert.flax_bridge import flax_to_state_dict
from super_resolution_tpu_torch.models import hat_classic_arch as thc
from super_resolution_tpu_torch.models import srformer_arch as tsrf
from super_resolution_tpu_torch.models import swinir_arch as tsw
from super_resolution_tpu_torch.ops import cuda_build
from super_resolution_tpu_torch.ops import cuda_ffn as tcf
from super_resolution_tpu_torch.ops import cuda_hab as tch
from super_resolution_tpu_torch.ops import cuda_hab_block as tchb
from super_resolution_tpu_torch.ops import cuda_psa as tcp
from super_resolution_tpu_torch.ops import cuda_window_attention as tcw
from super_resolution_tpu_torch.runtime import build_model
from flax_weights import random_params
from torch_threads import few_torch_threads  # noqa: F401

ATOL_GRAD = 2e-5
ATOL_NET = 3e-5
LR = 1e-3
ATOL_PARAM = LR / 10
MAX_FLIP_SHARE = 5e-3

# ------------------------------------------------------------ the entries
C, HID, HEADS, WS, SHIFT = 24, 48, 2, 8, 4


def _entry_inputs(rng):
    """name -> (port entry, port wrapper, plain version, args, kwargs, the
    JAX entry as a function of the args): small operands of each entry."""
    from super_resolution_tpu.ops import pallas_attention as jpa
    from super_resolution_tpu.ops import pallas_ffn as jpf
    from super_resolution_tpu.ops import pallas_hab as jph
    from super_resolution_tpu.models.srformer_arch import psa_shift_mask

    def t(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    x = t(2, 16, 16, C)
    ln = (1.0 + t(C, s=0.1), t(C, s=0.1))
    tail = (*ln, t(C, HID, s=C ** -0.5), t(HID, s=0.1),
            t(HID, C, s=HID ** -0.5), t(C, s=0.1))
    n, nk = WS * WS, (WS // 2) ** 2
    msa = (t(C, 3 * C, s=C ** -0.5), t(3 * C, s=0.1), t(C, C, s=C ** -0.5),
           t(C, s=0.1), t(HEADS, n, n, s=0.5))
    scale = (C // HEADS) ** -0.5
    psa = (x, t(C, C, s=C ** -0.5), t(C, s=0.1), t(C, C, s=C ** -0.5),
           t(C, s=0.1), t(2 * 4, nk, 2 * C, s=0.5), t(HEADS, n, nk, s=0.5))
    mask = psa_shift_mask(16, 16, WS, SHIFT)
    m2, mid = 2 * HID, 8
    ffn = (x, t(C, m2, s=C ** -0.5), t(m2, s=0.1), t(3, 3, m2, s=0.3),
           t(m2, s=0.1), t(m2 // 2, C, s=(m2 // 2) ** -0.5), t(C, s=0.1))
    front = (x, *ln, t(3, 3, C, mid, s=(9 * C) ** -0.5), t(mid, s=0.1),
             t(3, 3, mid, C, s=(9 * mid) ** -0.5), t(C, s=0.1))
    return {
        "mlp_block_sum3": (
            tcf.mlp_block_sum3_ad, tcf.mlp_block_sum3,
            tcf.mlp_block_sum3_reference, (x, t(2, 16, 16, C), x * 0.5,
                                           *tail), dict(conv_scale=0.3),
            lambda *a: jpf.mlp_block_sum3_ad(*a, 0.3)),
        "mlp_block_sum3_shifted": (
            tcf.mlp_block_sum3_shifted_ad, tcf.mlp_block_sum3_shifted,
            tcf.mlp_block_sum3_shifted_reference,
            (x, t(2, 16, 16, C), x * 0.5, *tail),
            dict(conv_scale=0.3, shift=SHIFT),
            lambda *a: jpf.mlp_block_sum3_shifted_ad(*a, 0.3, SHIFT)),
        "fused_psa_block": (
            tcp.fused_psa_block_ad, tcp.fused_psa_block,
            tcp.psa_block_reference, psa,
            dict(mask=None, heads=HEADS, window_size=WS, scale=scale),
            lambda *a: jpa.fused_psa_block_ad(
                *a, jnp.zeros((1, n, nk), jnp.float32), HEADS, WS, scale)),
        "fused_psa_block_masked": (
            tcp.fused_psa_block_ad, tcp.fused_psa_block,
            tcp.psa_block_reference, psa,
            dict(mask=torch.from_numpy(mask), heads=HEADS, window_size=WS,
                 scale=scale),
            lambda *a: jpa.fused_psa_block_ad(*a, jnp.asarray(mask), HEADS,
                                              WS, scale)),
        "fused_hab_block": (
            tchb.fused_hab_block_ad, tchb.fused_hab_block,
            tchb.hab_block_reference,
            (x, t(2, 16, 16, C), t(2, 16, 16, C), *msa, *tail),
            dict(heads=HEADS, window_size=WS, scale=scale, conv_scale=0.3),
            lambda *a: jpa.fused_hab_block_ad(*a, HEADS, WS, scale, 0.3)),
        "msa_qtile_attention": (
            tcw.msa_qtile_attention_ad, tcw.msa_qtile_attention,
            tcw.msa_qtile_reference, (t(2, 16, 16, 3 * C), msa[4]),
            dict(heads=HEADS, window_size=WS, scale=scale),
            lambda *a: jpa.msa_qtile_attention_ad(*a, HEADS, WS, scale)),
        "hab_front": (
            tch.hab_front_ad, tch.hab_front, tch.hab_front_reference, front,
            dict(eps=1e-5, pdim=8),
            lambda *a: jph.hab_front_ad(*a, 1e-5, 8)),
        "gated_dconv_ffn": (
            tcf.gated_dconv_ffn_ad, tcf.gated_dconv_ffn, tcf.ffn_reference,
            ffn, {}, jpf.gated_dconv_ffn_ad),
    }


ENTRIES = ["mlp_block_sum3", "mlp_block_sum3_shifted", "fused_psa_block",
           "fused_psa_block_masked", "fused_hab_block",
           "msa_qtile_attention", "hab_front", "gated_dconv_ffn"]


def _cotangents(outs, rng):
    """A random cotangent of every output; hab_front's two pixel sums
    ((B, C) float32) get theirs over the 16 x 16 pixels, as the HAB takes
    their means, so that every gradient keeps the scale of the others."""
    return [(rng.standard_normal(tuple(o.shape))
             / (256.0 if o.dim() == 2 else 1.0)).astype(np.float32)
            for o in outs]


def _tuple(o):
    return o if isinstance(o, tuple) else (o,)


@pytest.mark.parametrize("name", ENTRIES)
def test_entry_gradient_matches_jax_ad(name, rng):
    """Every input's gradient of the port's entry (on the CPU: the plain
    version under autograd) against the JAX ``*_ad`` function's, for a
    random cotangent of every output; the forwards too."""
    ad, _, _, args, kw, jfn = _entry_inputs(rng)[name]
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    outs = _tuple(ad(*targs, **kw))
    cts = _cotangents(outs, rng)
    got = torch.autograd.grad(outs, targs, [torch.from_numpy(c)
                                            for c in cts])
    ref_out, vjp = jax.vjp(jax.jit(lambda *a: _tuple(jfn(*a))),
                           *map(jnp.asarray, args))
    ref = vjp(tuple(jnp.asarray(c) for c in cts))
    for o, r in zip(outs, ref_out):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r),
                                   atol=ATOL_GRAD, rtol=1e-4)
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL_GRAD,
                                   rtol=1e-4, err_msg=f"{name} input {i}")


@pytest.mark.parametrize("name", ENTRIES)
def test_entry_routes_every_gradient_through_its_plain_version(
        name, rng, monkeypatch):
    """The card's route of an entry (the autograd Function, its forward the
    wrapper with grad mode off, which on a CPU tensor runs the plain
    version): forward and every input's gradient equal autograd through
    the plain version, also where only some inputs ask for one."""
    ad, _, plain, args, kw, _ = _entry_inputs(rng)[name]
    monkeypatch.setattr(cuda_build, "use_kernel", lambda t: True)
    for need in (None, {0, 3}):
        def leaves():
            return [torch.from_numpy(a).requires_grad_(need is None
                                                       or i in need)
                    for i, a in enumerate(args)]
        a1, a2 = leaves(), leaves()
        o1, o2 = _tuple(ad(*a1, **kw)), _tuple(plain(*a2, **kw))
        assert all(o.grad_fn is not None and "PlainBackward" in
                   type(o.grad_fn).__name__ for o in o1[:1])
        for o, r in zip(o1, o2):
            assert torch.equal(o, r)
        cts = [torch.from_numpy(c) for c in _cotangents(o2, rng)]
        w1 = [x for x in a1 if x.requires_grad]
        w2 = [x for x in a2 if x.requires_grad]
        for x, y in zip(torch.autograd.grad(o1, w1, cts),
                        torch.autograd.grad(o2, w2, cts)):
            torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["mlp_block_sum3", "mlp_block_sum3_shifted",
                                  "fused_psa_block", "fused_hab_block",
                                  "msa_qtile_attention", "hab_front",
                                  "gated_dconv_ffn"])
def test_direct_kernel_call_for_a_gradient_raises(name, rng, monkeypatch):
    """The wrapper itself, on a tensor it would launch on, refuses an input
    that asks for a gradient: the kernels have no backward, the entries are
    the way through."""
    _, wrapper, _, args, kw, _ = _entry_inputs(rng)[name]
    monkeypatch.setattr(sys.modules[wrapper.__module__], "use_kernel",
                        lambda t: True)
    targs = [torch.from_numpy(a).requires_grad_(i == 0)
             for i, a in enumerate(args)]
    with pytest.raises(RuntimeError, match="no backward"):
        wrapper(*targs, **kw)


# ------------------------------------------------------------- drop path
TINY = dict(img_size=16, embed_dim=24, depths=(2, 2), num_heads=(2, 2),
            window_size=8, mlp_ratio=2.0, upscale=2,
            upsampler="pixelshuffle")
CLASSIC = dict(TINY, compress_ratio=3, squeeze_factor=6, conv_scale=0.01,
               overlap_ratio=0.5)
# label -> (JAX module path, port module, the network's options, the
# port-only options, the JAX route switches)
NETWORKS = {
    "classic_split": ("hat_classic_arch", thc, "HATClassic", CLASSIC, {},
                      {}),
    "classic_fused_hab_block": ("hat_classic_arch", thc, "HATClassic",
                                CLASSIC, {"hab_route": "fused_hab_block"},
                                {"SR_TPU_HAB_MEGA": "1"}),
    "swinir": ("swinir_arch", tsw, "SwinIR", TINY, {}, {}),
    "srformer": ("srformer_arch", tsrf, "SRFormer", TINY, {}, {}),
}
# the entries a block's route reaches; the OCAB's (row 5, which has no
# drop path) is left out: JAX's guard for its TPU kernel keeps it off at
# window 8 (an overlap window of 12 is no multiple of 8), the port's kernel
# takes it
SPIED = ("fused_msa_block_ad", "fused_msa_block_shifted_ad",
         "fused_hab_block_ad", "fused_psa_block_ad", "mlp_block_sum3_ad",
         "mlp_block_sum3_shifted_ad", "mlp_block_ad")


def _jax_arch(label):
    import importlib

    return importlib.import_module(
        f"super_resolution_tpu.models.{NETWORKS[label][0]}")


def _spy(monkeypatch, module, name, log, event):
    fn = getattr(module, name)

    def wrapped(*a, **k):
        log.append(event)
        return fn(*a, **k)
    monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("mode,rate", [("train", 0.2), ("train", 0.0),
                                       ("eval", 0.2)])
@pytest.mark.parametrize("label", list(NETWORKS))
def test_route_matches_jax_block_by_block(label, mode, rate, monkeypatch):
    """Each block of a forward takes JAX's route: its kernels in eval mode
    or where its rate is 0; at a rate above 0 in training its attention
    kernel, drop path on the attention branch, and its MLP unfused with
    drop path. JAX is traced (not run) with its kernel routes switched
    on; both sides log an event a call."""
    from super_resolution_tpu.ops import pallas_attention as jpa
    from super_resolution_tpu.ops import pallas_ffn as jpf

    _, tmod, arch, kw, port_kw, env = NETWORKS[label]
    monkeypatch.setenv("SR_TPU_ATTN", "pallas")
    monkeypatch.setenv("SR_TPU_FFN", "fused")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    events = {"jax": [], "port": []}
    jmod = _jax_arch(label)
    for name in SPIED:
        owner = jpa if hasattr(jpa, name) else jpf
        _spy(monkeypatch, owner, name, events["jax"], name)
        if hasattr(tmod, name):
            _spy(monkeypatch, tmod, name, events["port"], name)
    _spy(monkeypatch, jmod, "drop_path", events["jax"], "drop")
    _spy(monkeypatch, tmod, "drop_path", events["port"], "drop")
    if tmod is tsrf:
        monkeypatch.setattr(tsrf, "use_kernel", lambda t: True)

    kw = dict(kw, drop_path_rate=rate)
    jnet = getattr(jmod, arch)(**kw)
    x = jnp.zeros((2, 16, 16, 3))
    params = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0), x))
    events["jax"].clear()
    jax.eval_shape(
        lambda p: jnet.apply(p, x, deterministic=(mode == "eval"),
                             rngs={"droppath": jax.random.PRNGKey(1)}),
        params)
    tnet = getattr(tmod, arch)(**kw, **port_kw).train(mode == "train")
    with torch.no_grad():
        tnet(torch.zeros(2, 16, 16, 3), generator=torch.Generator())
    assert events["port"] == events["jax"]
    # block 0 of the network is the only one at rate 0
    drops = 2 * 3 if mode == "train" and rate else 0
    assert events["port"].count("drop") == drops
    assert events["port"].count("mlp_block_sum3_ad") == (
        2 if label == "classic_split" and not drops else
        1 if label == "classic_split" else 0)


def _nets(label, rng, rate=0.0):
    """The JAX network with random params (JAX's XLA routes: the same
    functions as the kernels' references) and the port's on the same
    weights."""
    _, tmod, arch, kw, port_kw, _ = NETWORKS[label]
    kw = dict(kw, drop_path_rate=rate)
    jnet = getattr(_jax_arch(label), arch)(**kw)
    shapes = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0),
                                              jnp.zeros((1, 16, 16, 3))))
    params = random_params(shapes["params"], rng)
    tnet = getattr(tmod, arch)(**kw, **port_kw)
    tnet.load_state_dict(flax_to_state_dict(params, tnet), strict=True)
    return jnet, params, tnet


@pytest.mark.parametrize("label", list(NETWORKS))
def test_rate_zero_train_mode_matches_jax_non_deterministic(label, rng,
                                                            monkeypatch):
    """At rate 0 a training-mode forward takes every kernel entry; its
    output and the input's gradient equal JAX's ``deterministic=False``."""
    for k in ("SR_TPU_ATTN", "SR_TPU_FFN"):
        monkeypatch.setenv(k, "xla")
    if NETWORKS[label][1] is tsrf:
        monkeypatch.setattr(tsrf, "use_kernel", lambda t: True)
    jnet, params, tnet = _nets(label, rng)
    x = rng.random((2, 16, 16, 3), dtype=np.float32)
    ct = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    ref, vjp = jax.vjp(jax.jit(lambda xx: jnet.apply(
        {"params": params}, xx, deterministic=False,
        rngs={"droppath": jax.random.PRNGKey(1)})), jnp.asarray(x))
    (ref_gx,) = vjp(jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tnet.train()(xt, generator=torch.Generator().manual_seed(0))
    (out * torch.from_numpy(ct)).sum().backward()
    for got, want in ((out.detach().numpy(), np.asarray(ref)),
                      (xt.grad.numpy(), np.asarray(ref_gx))):
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_NET * max(
            1.0, float(np.abs(want).max())))


def _grads(net, x, gt, seed):
    net.zero_grad(set_to_none=True)
    out = net.train()(x, generator=torch.Generator().manual_seed(seed))
    (out - gt).abs().mean().backward()
    return {k: p.grad.clone() for k, p in net.named_parameters()}


@pytest.mark.parametrize("label", ["classic_split",
                                   "classic_fused_hab_block", "swinir",
                                   "srformer"])
def test_remat_gives_the_same_gradients(label, rng):
    """Each group under torch.utils.checkpoint, drop path at rate 0.5 (its
    draws made once, outside the checkpointed regions): the gradients
    equal those without remat on the same generator seed; another seed
    gives others."""
    _, tmod, arch, kw, port_kw, _ = NETWORKS[label]
    kw = dict(kw, drop_path_rate=0.5, **port_kw)
    plain = getattr(tmod, arch)(**kw)
    remat = getattr(tmod, arch)(**kw, use_checkpoint=True)
    remat.load_state_dict(plain.state_dict())
    x = torch.from_numpy(rng.random((2, 16, 16, 3), dtype=np.float32))
    gt = torch.from_numpy(rng.random((2, 32, 32, 3), dtype=np.float32))
    ref = _grads(plain, x, gt, 3)
    got = _grads(remat, x, gt, 3)
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], rtol=1e-6, atol=1e-6,
                                   msg=k)
    other = _grads(plain, x, gt, 4)
    assert any(not torch.equal(other[k], ref[k]) for k in ref)


# ------------------------------------------- train.py's first step a path
FORK = dict(type="HAT", img_size=16, embed_dim=24, depths=[2], num_heads=[2],
            window_size=8, compress_ratio=3, squeeze_factor=6,
            conv_scale=0.01, overlap_ratio=0.5, mlp_ratio=2.0, upscale=2,
            upsampler="pixelshuffle", esc_pdim=8, esc_kernel=5,
            drop_path_rate=0.0)
ESC = dict(type="ESC", dim=16, pdim=8, kernel_size=5, n_blocks=1,
           conv_blocks=1, window_size=8, num_heads=2, upscaling_factor=2,
           exp_ratio=1.0)
# path -> (network_g, the port-only keys of each port runner held against
# the one JAX runner: the classic HAT's two routes against one JAX step)
STEP_PATHS = {
    "classic_both_routes": (dict(CLASSIC, type="HATClassic",
                                 drop_path_rate=0.0),
                            [{}, {"hab_route": "fused_hab_block"}]),
    "srformer": (dict(TINY, type="SRFormer", drop_path_rate=0.0), [{}]),
    "swinir": (dict(TINY, type="SwinIR", drop_path_rate=0.0), [{}]),
    "esc_qtile": (ESC, [{"attn_route": "msa_qtile_attention"}]),
    "fork_hab_front": (FORK, [{"front_route": "hab_front"}]),
}


def _step_options(net):
    return {
        "name": "routes", "model_type": "SRModel", "scale": 2, "num_gpu": 1,
        "manual_seed": 0, "is_train": True, "network_g": dict(net),
        "datasets": {}, "path": {"pretrain_network_g": None},
        "train": {"ema_decay": 0.999,
                  "optim_g": {"type": "Adam", "lr": LR, "weight_decay": 0,
                              "betas": [0.9, 0.99]},
                  "scheduler": {"type": "MultiStepLR",
                                "milestones": [250000], "gamma": 0.5},
                  "total_iter": 10, "warmup_iter": -1,
                  "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0,
                                "reduction": "mean"}}}


@pytest.mark.parametrize("path", list(STEP_PATHS))
def test_first_train_step_matches_jax(path, rng, monkeypatch):
    """The SR runner of ``train_HAT_SRx4_from_scratch.yml``'s kind (Adam,
    L1, EMA) on the path's network, one ``optimize_parameters``: the loss
    and the weights after the update against JAX's runner."""
    from super_resolution_tpu.models import build_network as j_build
    from super_resolution_tpu.runtime import build_model as j_build_model
    from super_resolution_tpu.runtime import sr_model as j_sr_model

    for k in ("SR_TPU_ATTN", "SR_TPU_FFN", "SR_TPU_HAB", "SR_TPU_LNS"):
        monkeypatch.setenv(k, "xla")
    if path == "srformer":
        monkeypatch.setattr(tsrf, "use_kernel", lambda t: True)
    net, port_routes = STEP_PATHS[path]
    shapes = jax.eval_shape(lambda: j_build(net).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))["params"])
    params = random_params(shapes, rng)
    monkeypatch.setattr(j_sr_model.SRModel, "_init_params",
                        lambda self: None)
    jmodel = j_build_model(_step_options(net))
    jmodel.params = jax.tree_util.tree_map(jnp.asarray, params)
    jmodel.setup_training()
    gt = rng.random((2, 32, 32, 3)).astype(np.float32)
    batch = {"lq": gt.reshape(2, 16, 2, 16, 2, 3).mean(axis=(2, 4)),
             "gt": gt}
    jmodel.optimize_parameters(batch, 1)
    for port_only in port_routes:
        model = build_model(_step_options(dict(net, **port_only)), "cpu")
        model.net_g.load_state_dict(flax_to_state_dict(params, model.net_g),
                                    strict=True)
        model.setup_training()
        model.optimize_parameters(batch, 1)
        np.testing.assert_allclose(model.get_current_log()["l_pix"],
                                   jmodel.get_current_log()["l_pix"],
                                   rtol=1e-5)
        ref = flax_to_state_dict(jax.device_get(jmodel.state.params),
                                 model.net_g)
        own = model.net_g.state_dict()
        d = torch.cat([(own[k].float() - v.float()).abs().flatten()
                       for k, v in ref.items() if v.is_floating_point()])
        assert float((d > ATOL_PARAM).float().mean()) <= MAX_FLIP_SHARE
        assert float(d.max()) <= 2 * LR
        before = flax_to_state_dict(params, model.net_g)
        moved = max(float((own[k] - v).abs().max())
                    for k, v in before.items() if v.is_floating_point())
        assert moved > 0.5 * LR


def test_new_training_paths_run_without_jax(tmp_path):
    """In a process without JAX: the classic HAT, SwinIR and SRFormer train
    a step at drop-path rate 0.2 under remat, SRGANModel and ESRGANModel
    build their networks and the VGG-style discriminator and take an
    iteration, ESRModel takes a step with a perceptual loss; no module of
    JAX, flax or the JAX package is loaded."""
    import os
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = f"""
import sys, numpy as np, torch
from super_resolution_tpu_torch.models.vgg_arch import seeded_vgg19_state_dict
from super_resolution_tpu_torch.runtime import build_model
torch.save(seeded_vgg19_state_dict(0), 'vgg.pth')
percep = dict(type='PerceptualLoss', vgg_weights_path='vgg.pth',
              layer_weights=dict(conv1_2=1.0))
train = dict(optim_g=dict(type='Adam', lr=1e-3),
             optim_d=dict(type='Adam', lr=1e-3),
             scheduler=dict(type='MultiStepLR', milestones=[9], gamma=0.5),
             total_iter=9, warmup_iter=-1,
             pixel_opt=dict(type='L1Loss', loss_weight=1.0))
tiny = dict(img_size=16, embed_dim=12, depths=[2], num_heads=[2],
            window_size=8, mlp_ratio=2, upscale=2, upsampler='pixelshuffle',
            drop_path_rate=0.2, use_checkpoint=True)
nets = [('SRModel', dict(tiny, type='HATClassic', squeeze_factor=4)),
        ('SRModel', dict(tiny, type='SwinIR')),
        ('SRModel', dict(tiny, type='SRFormer')),
        ('SRGANModel', dict(type='MSRResNet', num_feat=8, num_block=1,
                            upscale=2)),
        ('ESRGANModel', dict(type='RRDBNet', num_feat=8, num_block=1,
                             num_grow_ch=4, scale=2)),
        ('ESRModel', dict(tiny, type='HATClassic', squeeze_factor=4))]
for runner, net in nets:
    opt = dict(name='t', model_type=runner, scale=2, manual_seed=1,
               is_train=True, network_g=net, path={{}},
               train=dict(train))
    if runner.endswith('GANModel'):
        opt['network_d'] = dict(type='VGGStyleDiscriminator', num_feat=4)
        opt['train'].update(perceptual_opt=percep, gan_opt=dict(
            type='GANLoss', gan_type='vanilla', loss_weight=5e-3))
    if runner == 'ESRModel':
        opt['train'].update(perceptual_opt=percep)
    model = build_model(opt, 'cpu')
    model.setup_training()
    hw = 64 if runner.endswith('GANModel') else 16
    lq = np.random.default_rng(0).random((2, hw, hw, 3), np.float32)
    gt = lq.repeat(2, 1).repeat(2, 2)
    model.optimize_parameters(dict(lq=lq, gt=gt), 1)
    assert all(np.isfinite(float(v))
               for v in model.get_current_log().values()), runner
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'flax',
                                    'super_resolution_tpu'))
assert not bad, bad
print('ok')
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=str(tmp_path),
                       env={"PYTHONPATH": repo, "PATH": "",
                            "HOME": str(tmp_path)})
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-3000:]
