"""The parts of the port's training path against the JAX package, on the
CPU: the schedules at every step, the pixel losses, the train dataset and
loader (the same crops, flips and order, arrays equal), the training
options' paths for every shipped ``options/train`` file, drop path and the
fork HAB's route block by block, and the gradients of the plain versions of
the four kernels that training runs (rows 5 to 8) against ``jax.grad`` of
the JAX ``*_ad`` functions (their forwards in Pallas interpret mode).

Tolerances: the schedules agree to float32 rounding (JAX computes them in
float32); the losses, drop path and the gradients are float32 with
summation order the only difference."""

import glob
import os
import random

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from super_resolution_tpu_torch.data import build_dataloader, build_dataset
from super_resolution_tpu_torch.data.transforms import mod_crop
from super_resolution_tpu_torch.models import arch_util as tarch
from super_resolution_tpu_torch.models import hat_arch as that
from super_resolution_tpu_torch.ops import cuda_attention as tca
from super_resolution_tpu_torch.ops import cuda_build
from super_resolution_tpu_torch.ops import cuda_ffn as tcf
from super_resolution_tpu_torch.ops import cuda_hab as tch
from torch_threads import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# float32 gradients of small blocks: summation order only
ATOL_GRAD = 2e-5


def _train_opt(scheduler, warmup=-1, lr=2e-4):
    return {"optim_g": {"type": "Adam", "lr": lr}, "scheduler": scheduler,
            "warmup_iter": warmup}


SCHEDULES = {
    "multistep": ({"type": "MultiStepLR", "milestones": [5, 9, 9, 14],
                   "gamma": 0.5}, -1),
    "multistep_restart": ({"type": "MultiStepRestartLR",
                           "milestones": [4, 8, 13, 17], "gamma": 0.5,
                           "restarts": [10, 0],
                           "restart_weights": [0.5, 1.0]}, -1),
    "cosine_restart": ({"type": "CosineAnnealingRestartLR",
                        "periods": [6, 8, 6], "restart_weights": [1, 0.5,
                                                                  0.25],
                        "eta_min": 1e-7}, -1),
    "warmup": ({"type": "MultiStepLR", "milestones": [12], "gamma": 0.1},
               7),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_matches_jax_at_every_step(name):
    from super_resolution_tpu.runtime.schedulers import \
        build_schedule as j_build
    from super_resolution_tpu_torch.runtime.schedulers import build_schedule

    sched, warmup = SCHEDULES[name]
    opt = _train_opt(sched, warmup)
    got, ref = build_schedule(opt), j_build(opt)
    steps = range(0, 23)
    np.testing.assert_allclose([got(s) for s in steps],
                               [float(ref(s)) for s in steps],
                               rtol=1e-6, atol=1e-12)


LOSSES = [dict(type="L1Loss", loss_weight=0.7, reduction="mean"),
          dict(type="L1Loss", reduction="sum"),
          dict(type="MSELoss", loss_weight=2.0, reduction="mean"),
          dict(type="CharbonnierLoss", loss_weight=1.0, reduction="mean",
               eps=1e-6),
          dict(type="WeightedTVLoss", loss_weight=0.5, reduction="mean")]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("i", range(len(LOSSES)))
def test_loss_matches_jax(i, weighted, rng):
    from super_resolution_tpu.losses import build_loss as j_build
    from super_resolution_tpu_torch.losses import build_loss

    pred = rng.standard_normal((2, 9, 7, 3)).astype(np.float32)
    target = rng.standard_normal((2, 9, 7, 3)).astype(np.float32)
    weight = rng.random((2, 9, 7, 3)).astype(np.float32)
    got_fn, ref_fn = build_loss(LOSSES[i]), j_build(LOSSES[i])
    kw_t = {"weight": torch.from_numpy(weight)} if weighted else {}
    kw_j = {"weight": jnp.asarray(weight)} if weighted else {}
    if LOSSES[i]["type"] == "WeightedTVLoss":
        got = got_fn(torch.from_numpy(pred), **kw_t)
        ref = ref_fn(jnp.asarray(pred), **kw_j)
    else:
        got = got_fn(torch.from_numpy(pred), torch.from_numpy(target), **kw_t)
        ref = ref_fn(jnp.asarray(pred), jnp.asarray(target), **kw_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-6)


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """Six GT / LQ pairs of different sizes (x2), PNG."""
    root = tmp_path_factory.mktemp("pairs")
    rng = np.random.default_rng(3)
    for d in ("gt", "lq"):
        os.makedirs(root / d)
    for i, (h, w) in enumerate([(40, 48), (36, 36), (48, 40), (32, 44),
                                (40, 40), (44, 36)]):
        gt = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        lq = cv2.resize(gt, (w // 2, h // 2), interpolation=cv2.INTER_AREA)
        cv2.imwrite(str(root / "gt" / f"p{i}.png"), gt)
        cv2.imwrite(str(root / "lq" / f"p{i}.png"), lq)
    return str(root)


def _train_set_opt(pairs, ratio=1):
    return {"name": "pairs", "type": "PairedImageDataset", "phase": "train",
            "scale": 2, "dataroot_gt": os.path.join(pairs, "gt"),
            "dataroot_lq": os.path.join(pairs, "lq"), "gt_size": 16,
            "use_hflip": True, "use_rot": True, "batch_size_per_gpu": 4,
            "dataset_enlarge_ratio": ratio, "io_backend": {"type": "disk"}}


@pytest.mark.parametrize("ratio", [1, 3])
def test_train_loader_matches_jax(pairs, ratio):
    """Two epochs of batches: the same indices, crops, flips and
    transposes, arrays equal; a loader started at batch k of an epoch gives
    that epoch's batches from k on."""
    from super_resolution_tpu.data import build_dataloader as j_loader
    from super_resolution_tpu.data import build_dataset as j_dataset

    opt = _train_set_opt(pairs, ratio)
    got_loader = build_dataloader(build_dataset(opt), opt, seed=11)
    ref_loader = j_loader(j_dataset(opt), opt, seed=11)
    assert len(got_loader) == len(ref_loader) == 6 * ratio // 4
    for epoch in (0, 1):
        got = list(got_loader.epoch_iter(epoch))
        ref = list(ref_loader.epoch_iter(epoch))
        assert len(got) == len(ref) == len(got_loader)
        for g, r in zip(got, ref):
            assert g["lq_path"] == r["lq_path"]
            assert g["gt_path"] == r["gt_path"]
            for key in ("lq", "gt"):
                assert g[key].dtype == r[key].dtype == np.float32
                np.testing.assert_array_equal(g[key], r[key])
            assert g["lq"].shape == (4, 8, 8, 3)
            assert g["gt"].shape == (4, 16, 16, 3)
        later = list(got_loader.epoch_iter(epoch, start=1))
        assert len(later) == len(got) - 1
        for g, r in zip(later, got[1:]):
            np.testing.assert_array_equal(g["gt"], r["gt"])


def test_train_loader_with_meta_info_matches_jax(pairs, tmp_path):
    """A paired meta_info_file (GT names in an order of its own, sizes
    after them, as DF2K-sub's): the pairs it names, in its order, and two
    epochs of batches equal to JAX's."""
    from super_resolution_tpu.data import build_dataloader as j_loader
    from super_resolution_tpu.data import build_dataset as j_dataset

    meta = tmp_path / "meta_info.txt"
    meta.write_text("".join(f"p{i}.png (40,40,3)\n" for i in (5, 1, 3, 0)))
    opt = dict(_train_set_opt(pairs), meta_info_file=str(meta))
    got_set, ref_set = build_dataset(opt), j_dataset(opt)
    assert got_set.paths == ref_set.paths
    assert [os.path.basename(p["gt_path"]) for p in got_set.paths] == [
        "p5.png", "p1.png", "p3.png", "p0.png"]
    got_loader = build_dataloader(got_set, opt, seed=4)
    ref_loader = j_loader(ref_set, opt, seed=4)
    for epoch in (0, 1):
        got = list(got_loader.epoch_iter(epoch))
        ref = list(ref_loader.epoch_iter(epoch))
        assert len(got) == len(ref) == 1
        for g, r in zip(got, ref):
            assert g["gt_path"] == r["gt_path"]
            for key in ("lq", "gt"):
                np.testing.assert_array_equal(g[key], r[key])


def test_train_dataset_item_matches_jax_with_its_rng(pairs):
    from super_resolution_tpu.data import build_dataset as j_dataset
    from super_resolution_tpu.data.transforms import mod_crop as j_mod_crop

    opt = dict(_train_set_opt(pairs), use_hflip=False, mean=[0.5, 0.4, 0.3],
               std=[0.2, 0.3, 0.4])
    got_set, ref_set = build_dataset(opt), j_dataset(opt)
    got_set.seed(5)
    ref_set.seed(5)
    for i in (0, 3, 3, 5):
        g, r = got_set[i], ref_set[i]
        np.testing.assert_array_equal(g["lq"], r["lq"])
        np.testing.assert_array_equal(g["gt"], r["gt"])
    img = np.arange(7 * 9 * 3, dtype=np.float32).reshape(7, 9, 3)
    np.testing.assert_array_equal(mod_crop(img, 4), j_mod_crop(img, 4))


# keys the JAX package derives from its devices
DEVICE_KEYS = ("dist", "rank", "world_size", "num_gpu")


@pytest.mark.parametrize(
    "yml", sorted(glob.glob(os.path.join(REPO, "options/train/*.yml"))),
    ids=lambda p: os.path.basename(p)[:-4])
def test_training_options_match_jax(yml, tmp_path):
    """process_options(is_train=True): the experiment paths, the phases and
    every other key as JAX's, for every shipped training file."""
    from super_resolution_tpu.utils.options import \
        process_options as j_process
    from super_resolution_tpu.utils.options import yaml_load as j_load
    from super_resolution_tpu_torch.utils.options import (process_options,
                                                          yaml_load)

    random.seed(0)
    got = process_options(yaml_load(yml), str(tmp_path), is_train=True)
    random.seed(0)
    ref = j_process(j_load(yml), str(tmp_path), is_train=True)
    for key in DEVICE_KEYS:
        got.pop(key, None), ref.pop(key, None)
    assert got == ref
    assert got["path"]["models"] == os.path.join(
        str(tmp_path), "experiments", got["name"], "models")


def test_debug_training_options_match_jax(tmp_path):
    from super_resolution_tpu.utils.options import \
        process_options as j_process
    from super_resolution_tpu_torch.utils.options import (process_options,
                                                          yaml_load)

    yml = os.path.join(REPO, "options/train/train_HAT_SRx4_amp_remat.yml")
    got = process_options(yaml_load(yml), str(tmp_path), is_train=True,
                          debug=True, auto_resume=True)
    ref = j_process(yaml_load(yml), str(tmp_path), is_train=True,
                    debug=True, auto_resume=True)
    assert got["name"] == ref["name"] == "debug_train_HAT_SRx4_amp_remat"
    assert got["logger"] == ref["logger"] and got["val"] == ref["val"]
    assert got["path"] == ref["path"] and got["auto_resume"]


def test_drop_path_matches_jax_formula(rng):
    """The same uniform draws give JAX's x / keep * floor(keep + u); the
    identity at rate 0."""
    from super_resolution_tpu.models.arch_util import drop_path as j_drop

    x = rng.standard_normal((6, 4, 5, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    u = np.array(jax.random.uniform(key, (6, 1, 1, 1)))
    for rate in (0.2, 0.5):
        ref = np.asarray(j_drop(jnp.asarray(x), rate, False, key))
        got = tarch.drop_path(torch.from_numpy(x), rate,
                              torch.from_numpy(u.reshape(6)))
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=0)
    xt = torch.from_numpy(x)
    assert tarch.drop_path(xt, 0.0, torch.zeros(6)) is xt


TINY_KW = dict(img_size=16, embed_dim=24, depths=(2, 2), num_heads=(2, 2),
               window_size=8, compress_ratio=3, squeeze_factor=6,
               conv_scale=0.01, overlap_ratio=0.5, mlp_ratio=2.0, upscale=2,
               upsampler="pixelshuffle")


@pytest.mark.parametrize("mode,rate", [("train", 0.2), ("train", 0.0),
                                       ("eval", 0.2)])
def test_hab_route_matches_jax_block_by_block(mode, rate, monkeypatch):
    """Each HAB of a forward takes JAX's route: the kernels (ln_split, then
    the gated FFN block) in eval mode or where its rate is 0, else the
    unfused modules with drop path on both branches. JAX is traced (not run)
    with its kernel routes switched on; both sides log a route a call."""
    from super_resolution_tpu.models import hat_arch as jhat
    from super_resolution_tpu.ops import pallas_ffn as jffn

    monkeypatch.setenv("SR_TPU_LNS", "fused")
    monkeypatch.setenv("SR_TPU_FFN", "fused")
    monkeypatch.setenv("SR_TPU_HAB", "xla")
    events = {"jax": [], "port": []}

    def spy(log, name, fn):
        def wrapped(*a, **k):
            events[log].append(name)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(jhat.HAB, "_split_front",
                        spy("jax", "kernel_front", jhat.HAB._split_front))
    monkeypatch.setattr(jffn, "gated_dconv_ffn_block_ad",
                        spy("jax", "kernel_ffn",
                            jffn.gated_dconv_ffn_block_ad))
    monkeypatch.setattr(jhat, "drop_path", spy("jax", "drop", jhat.drop_path))
    monkeypatch.setattr(that, "ln_split_ad",
                        spy("port", "kernel_front", that.ln_split_ad))
    monkeypatch.setattr(that, "gated_dconv_ffn_block_ad",
                        spy("port", "kernel_ffn",
                            that.gated_dconv_ffn_block_ad))
    monkeypatch.setattr(that, "drop_path", spy("port", "drop",
                                               that.drop_path))

    kw = dict(TINY_KW, drop_path_rate=rate)
    jnet = jhat.HAT(**kw)
    x = jnp.zeros((2, 16, 16, 3))
    params = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0), x))
    events["jax"].clear()
    jax.eval_shape(
        lambda p: jnet.apply(p, x, deterministic=(mode == "eval"),
                             rngs={"droppath": jax.random.PRNGKey(1)}),
        params)
    tnet = that.HAT(**kw).train(mode == "train")
    with torch.no_grad():
        tnet(torch.zeros(2, 16, 16, 3), generator=torch.Generator())
    assert events["port"] == events["jax"]
    kernels = ["kernel_front", "kernel_ffn"]
    if mode == "train" and rate:
        # block 0 of the network is the only one at rate 0
        assert events["port"] == kernels + ["drop", "drop"] * 3
    else:
        assert events["port"] == kernels * 4


def _row_inputs(rng):
    """Operands of rows 5 to 8 at a small size: (2, 16, 16, 24), 2 heads,
    window 8, overlap window 12, hidden 48, ESC slab 8."""
    def t(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    c, hid, m2, heads, ws, ow = 24, 48, 48, 2, 8, 12
    x = t(2, 16, 16, c)
    ln = (1.0 + t(c, s=0.1), t(c, s=0.1))
    return {
        "ln_split": ((x, *ln), dict(eps=1e-5, pdim=8)),
        "gated_dconv_ffn_block": (
            (x, *ln, t(c, m2, s=c ** -0.5), t(m2, s=0.1), t(3, 3, m2, s=0.3),
             t(m2, s=0.1), t(m2 // 2, c, s=(m2 // 2) ** -0.5), t(c, s=0.1)),
            {}),
        "mlp_block": ((x, *ln, t(c, hid, s=c ** -0.5), t(hid, s=0.1),
                       t(hid, c, s=hid ** -0.5), t(c, s=0.1)), {}),
        "fused_ocab_block": (
            (x, *ln, t(c, c, s=c ** -0.5), t(c, s=0.1),
             t(c, 2 * c, s=c ** -0.5), t(2 * c, s=0.1), t(c, c, s=c ** -0.5),
             t(c, s=0.1), t(heads, ws * ws, ow * ow, s=0.5)),
            dict(heads=heads, window_size=ws, overlap_win=ow,
                 scale=(c // heads) ** -0.5)),
    }


PORT_AD = {"ln_split": tch.ln_split_ad,
           "gated_dconv_ffn_block": tcf.gated_dconv_ffn_block_ad,
           "mlp_block": tcf.mlp_block_ad,
           "fused_ocab_block": tca.fused_ocab_block_ad}
PORT_PLAIN = {"ln_split": tch.ln_split_reference,
              "gated_dconv_ffn_block": tcf.ffn_block_reference,
              "mlp_block": tcf.mlp_block_reference,
              "fused_ocab_block": tca.ocab_block_reference}


def _jax_ad(name, args, kw):
    from super_resolution_tpu.ops import pallas_attention as jpa
    from super_resolution_tpu.ops import pallas_ffn as jpf
    from super_resolution_tpu.ops import pallas_hab as jph

    if name == "ln_split":
        return lambda *a: jph.ln_split_ad(*a, kw["eps"], kw["pdim"])
    if name == "gated_dconv_ffn_block":
        return jpf.gated_dconv_ffn_block_ad
    if name == "mlp_block":
        return jpf.mlp_block_ad
    return lambda *a: jpa.fused_ocab_block_ad(
        *a, kw["heads"], kw["window_size"], kw["overlap_win"], kw["scale"])


def _cotangents(outs, rng):
    outs = outs if isinstance(outs, tuple) else (outs,)
    return [rng.standard_normal(tuple(o.shape)).astype(np.float32)
            for o in outs]


@pytest.mark.parametrize("name", list(PORT_AD))
def test_row_gradient_matches_jax_ad(name, rng):
    """Every input's gradient of the port's ``*_ad`` entry (on the CPU: the
    plain version under autograd) against ``jax.grad`` of the JAX ``*_ad``
    function, for a random cotangent of every output."""
    args, kw = _row_inputs(rng)[name]
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    outs = PORT_AD[name](*targs, **kw)
    cts = _cotangents(outs, rng)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o * torch.from_numpy(ct)).sum() for o, ct in zip(outs, cts))
    got = torch.autograd.grad(loss, targs)

    fn = _jax_ad(name, args, kw)

    def jloss(*a):
        o = fn(*a)
        o = o if isinstance(o, tuple) else (o,)
        return sum(jnp.sum(oi * jnp.asarray(ct)) for oi, ct in zip(o, cts))

    ref = jax.grad(jloss, argnums=tuple(range(len(args))))(
        *map(jnp.asarray, args))
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL_GRAD,
                                   rtol=1e-4, err_msg=f"{name} input {i}")


@pytest.mark.parametrize("name", list(PORT_AD))
def test_plain_backward_function_routes_every_gradient(name, rng):
    """The autograd Function the card's ``*_ad`` entries go through, with the
    plain version standing in for the kernel (the card is not here): every
    input's gradient equals autograd through the plain version, also where
    only some inputs ask for one."""
    args, kw = _row_inputs(rng)[name]
    plain = lambda *a: PORT_PLAIN[name](*a, **kw)  # noqa: E731
    for need in (None, {0, 3}):
        def leaves():
            return [torch.from_numpy(a).requires_grad_(need is None
                                                       or i in need)
                    for i, a in enumerate(args)]
        a1, a2 = leaves(), leaves()
        o1 = cuda_build._PlainBackward.apply(plain, plain, *a1)
        o2 = plain(*a2)
        o1 = o1 if isinstance(o1, tuple) else (o1,)
        o2 = o2 if isinstance(o2, tuple) else (o2,)
        cts = [torch.from_numpy(c) for c in _cotangents(o2, rng)]
        for o, r in zip(o1, o2):
            assert torch.equal(o, r)
        w1 = [t for t in a1 if t.requires_grad]
        w2 = [t for t in a2 if t.requires_grad]
        g1 = torch.autograd.grad(o1, w1, cts)
        g2 = torch.autograd.grad(o2, w2, cts)
        for x, y in zip(g1, g2):
            torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_direct_kernel_call_asking_for_a_gradient_raises():
    """The kernels have no backward: a wrapper's operand check refuses a
    call that records a gradient; the ``*_ad`` entries are the way through."""
    t = torch.ones(4, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        cuda_build.check_operands("ln_split", t, x=t)
    with torch.no_grad():
        assert cuda_build.check_operands("ln_split", t, x=t) == 0


def test_with_plain_backward_routes_by_grad_mode(monkeypatch):
    """On a tensor that takes the kernel, an ``*_ad`` entry records the
    autograd Function only where a gradient is asked for: in no-grad mode,
    or where no input requires one, it calls the wrapper itself. The
    Function's forward is the wrapper's output, with grad mode off inside
    (so the wrapper launches), and its gradients are autograd's through the
    plain version (exact here: the same float32 operations)."""
    monkeypatch.setattr(cuda_build, "use_kernel", lambda t: True)
    calls = []

    def plain(x, w, *, s):
        return torch.tanh(x * w) * s, x.sum(-1)

    def kernel(x, w, *, s):
        calls.append(torch.is_grad_enabled())
        with torch.no_grad():
            return plain(x, w, s=s)

    g = torch.Generator().manual_seed(4)
    x = torch.randn(3, 5, generator=g, requires_grad=True)
    w = torch.randn(5, generator=g)
    with torch.no_grad():
        out = cuda_build.with_plain_backward(kernel, plain, (x, w), s=2.0)
    assert calls == [False] and out[0].grad_fn is None
    out = cuda_build.with_plain_backward(kernel, plain, (x.detach(), w),
                                         s=2.0)
    assert calls == [False, True] and out[0].grad_fn is None

    w.requires_grad_(True)
    got = cuda_build.with_plain_backward(kernel, plain, (x, w), s=2.0)
    assert calls == [False, True, False]
    ref = plain(x, w, s=2.0)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    cot = [torch.randn(r.shape, generator=g) for r in ref]
    got_grads = torch.autograd.grad(got, (x, w), cot)
    ref_grads = torch.autograd.grad(ref, (x, w), cot)
    for a, b in zip(got_grads, ref_grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_prefetch_iterator_close_ends_its_worker():
    """A consumer that stops early closes the iterator: the worker, blocked
    on a full queue, ends and lets go of its items; a closed iterator
    closes again at no cost, and an iterator read to its end has no worker
    left."""
    from super_resolution_tpu_torch.data import PrefetchIterator

    made = []

    def endless():
        while True:
            made.append(len(made))
            yield made[-1]

    it = PrefetchIterator(endless(), num_prefetch=2)
    assert [next(it), next(it)] == [0, 1]
    it.close()
    assert not it._thread.is_alive() and it._queue.empty()
    assert len(made) <= 6
    it.close()
    done = PrefetchIterator(iter(range(3)))
    assert list(done) == [0, 1, 2] and not done._thread.is_alive()
    done.close()
