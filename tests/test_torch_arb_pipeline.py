"""The port's arbitrary-scale app on the CPU against the JAX package's: the
implicit datasets' items for a seed, ``eval_arb`` on two shipped test files
(``test-div2k-6.yml``: chunked queries over downscaled GT;
``test-fast-set5-4.yml``: paired LR / HR, one call) with a bridged tiny
LIIF on synthetic PNGs, ``train_arb`` for three steps of a tiny LIIF from
JAX's initial weights, the gradients of the three autograd entries this
slice adds (``fused_msa_block_shifted_ad``, ``fused_msa_attention_ad``,
``fused_scc_block_ad``) against ``jax.grad`` of the JAX entries (their
forwards in Pallas interpret mode), the 14 shipped training files that
fail in JAX failing in the port in the same way, and the app and the new
archs running in a process without JAX.

Tolerances: the datasets' arrays are equal (the same numpy arithmetic and
draws); PSNR 1e-4 dB; float32 training, summation order only: losses 1e-5
relative, parameters 1e-4 after three Adam steps at lr 1e-3; gradients of
small blocks 2e-5 absolute, 1e-4 relative.
"""

import glob
import os

import cv2
import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from super_resolution_tpu.arb import models as jmodels
from super_resolution_tpu_torch import arb
from super_resolution_tpu_torch.convert.flax_bridge import flax_to_state_dict
from super_resolution_tpu_torch.ops import cuda_attention as tca
from super_resolution_tpu_torch.ops import cuda_scc as tcs
from super_resolution_tpu_torch.ops import cuda_window_attention as tcw
from super_resolution_tpu_torch.ops.attention import shift_attn_mask_tensor
from flax_weights import bridge
from torch_threads import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARB = os.path.join(REPO, "options", "arb")
ATOL_GRAD = 2e-5
TINY_LIIF = {"name": "liif", "args": {
    "encoder_spec": {"name": "edsr-baseline",
                     "args": {"n_resblocks": 1, "n_feats": 8}},
    "imnet_spec": {"name": "mlp", "args": {"out_dim": 3,
                                           "hidden_list": [16, 16]}}}}


def _images(root, sizes, seed):
    """Smooth synthetic RGB PNGs with a little noise, named 000.png, ...;
    returns their paths."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for i, (h, w) in enumerate(sizes):
        yy, xx = np.mgrid[0:h, 0:w] / 9.0
        img = 0.5 + 0.35 * np.sin(yy[..., None] * rng.uniform(0.5, 2)
                                  + xx[..., None] * rng.uniform(0.5, 2)
                                  + np.arange(3))
        img = np.clip(img + rng.normal(0, 0.03, img.shape), 0, 1)
        paths.append(os.path.join(root, f"{i:03d}.png"))
        cv2.imwrite(paths[-1], (img * 255).round().astype(np.uint8))
    return paths


def _downsampled(root, **wrapper):
    return {"type": "SRImplicitDownsampled",
            "dataset": {"type": "DownsampleImageDataset",
                        "dataroot_gt": root, "scale": 2, "phase": "train"},
            **wrapper}


def _build(pkg, opt):
    if pkg == "jax":
        from super_resolution_tpu.data import build_dataset
    else:
        from super_resolution_tpu_torch.data import build_dataset
    return build_dataset(opt)


@pytest.mark.parametrize("wrapper", [
    dict(inp_size=12, scale_min=1, scale_max=4, sample_q=100, augment=True),
    dict(scale_min=2.5, scale_max=3.5)], ids=["crops", "whole"])
def test_implicit_downsampled_items_equal_jax(wrapper, tmp_path):
    root = str(tmp_path / "gt")
    _images(root, [(56, 60), (64, 50), (50, 52)], seed=1)
    opt = _downsampled(root, **wrapper)
    jds, tds = _build("jax", opt), _build("torch", opt)
    for ds in (jds, tds):
        ds.seed(7)
    for i in (0, 2, 1, 0):
        ref, got = jds[i], tds[i]
        assert sorted(got) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def _set5(root, scale=4):
    """Paired HR / LR_bicubic/X<s> PNGs named as Set5's, '{}x<s>'."""
    from super_resolution_tpu_torch.utils.matlab import imresize

    hr = os.path.join(root, "HR")
    lr = os.path.join(root, "LR_bicubic", f"X{scale}")
    os.makedirs(lr, exist_ok=True)
    for path in _images(hr, [(48, 56), (40, 44)], seed=2):
        img = cv2.imread(path)[..., ::-1].astype(np.float32) / 255.0
        low = np.clip(imresize(img, 1 / scale), 0, 1)
        name = os.path.basename(path)[:-4]
        cv2.imwrite(os.path.join(lr, f"{name}x{scale}.png"),
                    (low[..., ::-1] * 255).round().astype(np.uint8))
    return hr, lr


def test_implicit_paired_items_equal_jax(tmp_path):
    hr, lr = _set5(str(tmp_path))
    opt = {"type": "SRImplicitPaired", "sample_q": 50,
           "dataset": {"type": "PairedImageDataset", "dataroot_gt": hr,
                       "dataroot_lq": lr, "filename_tmpl": "{}x4",
                       "scale": 4, "io_backend": {"type": "disk"}}}
    jds, tds = _build("jax", opt), _build("torch", opt)
    for i in (1, 0, 1):
        ref, got = jds[i], tds[i]
        for k in ("inp", "coord", "cell", "gt"):
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def _test_config(name, tmp_path):
    """A shipped test file with its data roots on synthetic images."""
    with open(os.path.join(ARB, "test", name)) as f:
        config = yaml.safe_load(f)
    ds = config["test_dataset"]["dataset"]
    if "dataroot_lq" in ds:
        ds["dataroot_gt"], ds["dataroot_lq"] = _set5(str(tmp_path))
    else:
        ds["dataroot_gt"] = str(tmp_path / "div2k")
        _images(ds["dataroot_gt"], [(74, 80), (62, 70)], seed=3)
    return config


class _Jitted:
    """A JAX module whose init and apply are jitted: one compile a shape,
    not one an op, as the JAX package runs them eagerly."""

    def __init__(self, model):
        self.model, self.init = model, jax.jit(model.init)
        self.apply = jax.jit(model.apply, static_argnames=("method",))

    def __getattr__(self, name):
        return getattr(self.model, name)


def _tiny_liif(rng):
    jmod, tmod = jmodels.make(TINY_LIIF), arb.make(TINY_LIIF)
    params = bridge(jmod, tmod, rng, np.zeros((1, 8, 8, 3), np.float32),
                    np.zeros((1, 4, 2), np.float32),
                    np.zeros((1, 4, 2), np.float32))
    return jmod, params, tmod


@pytest.mark.parametrize("name", ["test-div2k-6.yml",
                                  "test-fast-set5-4.yml"])
def test_eval_arb_equals_jax(name, tmp_path, rng):
    """The PSNR of a bridged tiny LIIF. The paired benchmark files name no
    ``scale`` for their PairedImageDataset, which reads it: the file as
    shipped fails in both packages (KeyError), and with ``scale: 4`` added
    both evaluate."""
    from super_resolution_tpu.arb.eval import eval_arb as j_eval

    config = _test_config(name, tmp_path)
    jmod, params, tmod = _tiny_liif(rng)
    if "set5" in name:
        for run in (lambda: j_eval(config, _Jitted(jmod), params),
                    lambda: arb.eval_arb(config, tmod, device="cpu")):
            with pytest.raises(KeyError, match="scale"):
                run()
        config["test_dataset"]["dataset"]["scale"] = 4
    ref = j_eval(config, _Jitted(jmod), params)
    got = arb.eval_arb(config, tmod, device="cpu")
    assert np.isfinite(got) and abs(got - ref) <= 1e-4, (got, ref)


def _train_config(root):
    """train_edsr-baseline-liif.yml with a tiny LIIF, 6 GT images and
    batches of 2: one epoch of three steps."""
    with open(os.path.join(ARB, "train-div2k",
                           "train_edsr-baseline-liif.yml")) as f:
        config = yaml.safe_load(f)
    config["model"] = TINY_LIIF
    ds = config["train_dataset"]
    ds["dataset"]["dataroot_gt"] = root
    ds.update(inp_size=10, sample_q=64, batch_size=2)
    config.update(epoch_max=1, epoch_save=1, optimizer={"lr": 1e-3},
                  multi_step_lr={"milestones": [1], "gamma": 0.5})
    del config["val_dataset"]
    return config


def test_train_arb_three_steps_equal_jax(tmp_path, monkeypatch):
    """Three Adam steps of a tiny LIIF: JAX's train_arb from its own
    initial weights, the port's from the same weights (its seeded init
    replaced by them) on the same batches: each step's loss, then the
    parameters, and the checkpoints."""
    from super_resolution_tpu.arb import train as jtrain
    from super_resolution_tpu_torch.arb import train as ttrain
    from super_resolution_tpu_torch.runtime.checkpoint import STATE_FILE

    root = str(tmp_path / "gt")
    _images(root, [(44, 48)] * 6, seed=4)
    config = _train_config(root)
    record = {"losses": []}
    make_step = jtrain.make_train_step

    def recording(model, tx):
        step = make_step(model, tx)

        def wrapped(params, opt_state, batch):
            record.setdefault("init", jax.device_get(params))
            params, opt_state, loss = step(params, opt_state, batch)
            record["losses"].append(float(loss))
            return params, opt_state, loss
        return wrapped
    make = jtrain.make
    monkeypatch.setattr(jtrain, "make_train_step", recording)
    monkeypatch.setattr(jtrain, "make", lambda spec: _Jitted(make(spec)))
    # JAX's checkpoints are not compared (orbax's first save takes ~5 s)
    monkeypatch.setattr("super_resolution_tpu.runtime.checkpoint.save_params",
                        lambda *a, **k: None)
    _, ref_params = jtrain.train_arb(config, str(tmp_path / "jax"))

    monkeypatch.setattr(ttrain, "init_weights", lambda m, g: m.load_state_dict(
        flax_to_state_dict(record["init"], m), strict=True))
    model, losses = ttrain.train_arb(config, str(tmp_path / "port"),
                                     device="cpu")
    assert len(losses) == len(record["losses"]) == 3
    np.testing.assert_allclose(losses, record["losses"], rtol=1e-5)
    ref = flax_to_state_dict(jax.device_get(ref_params), model)
    now = model.state_dict()
    diffs = torch.cat([(now[k] - ref[k]).abs().flatten() for k in ref])
    assert float(diffs.max()) <= 1e-4
    start = flax_to_state_dict(record["init"], model)
    assert max(float((now[k] - start[k]).abs().max()) for k in ref) > 1e-3
    for name in ("epoch-1", "epoch-last"):
        saved = torch.load(os.path.join(tmp_path, "port", name, STATE_FILE))
        assert saved["epoch"] == 1
        torch.testing.assert_close(saved["params"], now)


def _entry_inputs(rng, name):
    """Operands of the three new entries at a small size: rows 2 and 12 at
    C 16 in 2 heads, window 8, shift 4, on (2, 16, 24) images with their
    shift mask; row 14 at C 20 in 2 heads, window 8 on base 4."""
    def t(*shape, s=1.0):
        return np.asarray(rng.standard_normal(shape) * s, np.float32)

    c, heads, ws, n = 16, 2, 8, 64
    scale = (c // heads) ** -0.5
    mask = shift_attn_mask_tensor(16, 24, ws, 4, "cpu").numpy()
    if name == "fused_msa_block_shifted":
        return ((t(2, 16, 24, c), t(c, 3 * c, s=c ** -0.5), t(3 * c, s=0.1),
                 t(c, c, s=c ** -0.5), t(c, s=0.1), t(heads, n, n, s=0.5)),
                mask, dict(heads=heads, window_size=ws, shift=4,
                           scale=scale))
    if name in ("fused_msa_attention", "fused_msa_attention_unmasked"):
        return ((t(2, 16, 24, 3 * c, s=0.5), t(heads, n, n, s=0.5)),
                None if name.endswith("unmasked") else mask,
                dict(heads=heads, window_size=ws, scale=scale))
    return ((t(2, 16, 24, 20), t(4, s=0.5), t(s=0.1), t(20, 20, s=0.2),
             t(20, s=0.1), t(2, 64, 16, s=0.5)), None,
            dict(heads=2, window_size=(8, 8), base=(4, 4)))


def _port_entry(name, mask, kw):
    if name == "fused_msa_block_shifted":
        return lambda *a: tca.fused_msa_block_shifted_ad(
            *a[:6], torch.from_numpy(mask), **kw)
    if name.startswith("fused_msa_attention"):
        m = None if mask is None else torch.from_numpy(mask)
        return lambda *a: tcw.fused_msa_attention_ad(*a, m, **kw)
    return lambda *a: tcs.fused_scc_block_ad(*a, **kw)


def _jax_entry(name, mask, kw):
    from super_resolution_tpu.ops import pallas_attention as jpa

    if name == "fused_msa_block_shifted":
        return lambda *a: jpa.fused_msa_block_shifted_ad(
            *a, jnp.asarray(mask), kw["heads"], kw["window_size"],
            kw["shift"], kw["scale"])
    if name.startswith("fused_msa_attention"):
        n = kw["window_size"] ** 2
        m = (jnp.zeros((1, n, n), jnp.float32) if mask is None
             else jnp.asarray(mask))
        return lambda *a: jpa.fused_msa_attention_ad(
            *a, m, kw["heads"], kw["window_size"], kw["scale"])
    return lambda *a: jpa.fused_scc_block_ad(*a, kw["heads"],
                                             kw["window_size"], kw["base"])


@pytest.mark.parametrize("name", ["fused_msa_block_shifted",
                                  "fused_msa_attention",
                                  "fused_msa_attention_unmasked",
                                  "fused_scc_block"])
def test_new_entry_gradient_matches_jax_ad(name, rng):
    """Every differentiable input's gradient of the port's entry (on the
    CPU: the plain version under autograd) against ``jax.vjp`` of the JAX
    entry for a random cotangent; the forwards agree too."""
    args, mask, kw = _entry_inputs(rng, name)
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    out = _port_entry(name, mask, kw)(*targs)
    ct = rng.standard_normal(tuple(out.shape)).astype(np.float32)
    got = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), targs)
    jout, vjp = jax.vjp(jax.jit(_jax_entry(name, mask, kw)),
                        *(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=ATOL_GRAD, rtol=1e-4)
    ref = vjp(jnp.asarray(ct))
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL_GRAD,
                                   rtol=1e-4, err_msg=f"{name} input {i}")


def _failing_files():
    names = (["train_edsr-baseline-lte-fast.yml"]
             + [f"train_{e}-{h}.yml" for e in ("esc",) for h in ("lte",)]
             + [f"train_{e}-{h}.yml" for e in ("rdn", "swinir")
                for h in ("liif", "lte", "metasr")]
             + [f"train_{e}-x{s}.yml" for e in ("edsr-baseline", "rdn")
                for s in (2, 3, 4)])
    return sorted(names)


def test_the_failing_files_are_the_shipped_remainder():
    """The 19 shipped training files: the 14 below fail in both packages;
    the other five train (chip_smoke.py phase 10)."""
    shipped = sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(ARB, "train-div2k", "*.yml")))
    assert len(shipped) == 19 and set(_failing_files()) <= set(shipped)
    trains = sorted(set(shipped) - set(_failing_files()))
    assert trains == ["train_atd-lte.yml", "train_edsr-baseline-liif.yml",
                      "train_edsr-baseline-lte.yml",
                      "train_edsr-baseline-metasr.yml",
                      "train_hitsrf-lte.yml"]


@pytest.mark.parametrize("name", _failing_files())
def test_file_fails_as_in_jax(name, tmp_path):
    """The fixed-scale files pass ``scale`` to an encoder that has no such
    field; the ESC, RDN and SwinIR files pass ``no_upsampling`` to encoders
    without it: both packages raise a TypeError building the encoder spec.
    LTE+ takes (B, Hq, Wq, 2) query grids, and SRImplicitDownsampled hands
    it flat (B, Q, 2) coordinates: both packages fail to reshape them on
    the first batch."""
    with open(os.path.join(ARB, "train-div2k", name)) as f:
        config = yaml.safe_load(f)
    spec = config["model"]["args"]["encoder_spec"]
    if "lte-fast" not in name:
        bad = "scale" if "-x" in name else "no_upsampling"
        for make in (jmodels.make, arb.make):
            with pytest.raises(TypeError, match=bad):
                make(spec)
        return
    root = str(tmp_path / "gt")
    _images(root, [(40, 40)] * 2, seed=5)
    ds = dict(config["train_dataset"], inp_size=8, sample_q=16)
    ds["dataset"] = dict(ds["dataset"], dataroot_gt=root)
    item = _build("torch", ds)[0]
    batch = [item[k][None] for k in ("inp", "coord", "cell")]
    small = {"name": "lte-fast", "args": {
        "encoder_spec": {"name": "edsr-baseline",
                         "args": dict(spec["args"], n_resblocks=1,
                                      n_feats=8)},
        "num_layer": 1, "hidden_dim": 8}}
    jmod = jmodels.make(small)
    with pytest.raises(TypeError, match="reshape"):
        # traced only: the reshape fails as the init is traced
        jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                       *map(jnp.asarray, batch))
    with pytest.raises(RuntimeError, match="shape .* is invalid"):
        arb.make(small)(*map(torch.from_numpy, batch))


def test_arb_and_hatx_run_without_jax():
    """The app and the new archs import and run in a process with no JAX
    (a subprocess: this one has JAX loaded)."""
    import subprocess
    import sys

    code = (
        "import sys, torch\n"
        "from super_resolution_tpu_torch import arb\n"
        "from super_resolution_tpu_torch.arb.train import train_arb\n"
        "from super_resolution_tpu_torch.models import build_network\n"
        "spec = {'name': 'lte', 'args': {'encoder_spec': {'name': 'swinir',\n"
        "    'args': {'embed_dim': 12, 'depths': [2], 'num_heads': [2]}},\n"
        "    'imnet_spec': {'name': 'mlp', 'args': {'out_dim': 3,\n"
        "    'hidden_list': [8]}}, 'hidden_dim': 8}}\n"
        "coord = torch.from_numpy(arb.make_coord((20, 20))[None])\n"
        "out = arb.make(spec)(torch.rand(1, 10, 10, 3), coord,\n"
        "                     torch.full_like(coord, 0.1))\n"
        "assert out.shape == (1, 400, 3), out.shape\n"
        "net = build_network(dict(type='HybridHATNAF', naf_width=8,\n"
        "    naf_blocks=1, window_size=8, hat_kwargs=dict(embed_dim=12,\n"
        "    depths=[1], num_heads=[2], esc_pdim=4, esc_kernel=3,\n"
        "    use_focus_bias=True, kv_topk_ratio=0.5)))\n"
        "assert net(torch.rand(1, 8, 8, 3)).shape == (1, 16, 16, 3)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'flax', 'super_resolution_tpu')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=300)


def test_shift_mask_cached_in_inference_mode_trains():
    """The shift mask is cached across callers; one first built under
    ``torch.inference_mode`` (an inference forward) is still a normal
    tensor, which the card's autograd Function saves for its backward (the
    plain version standing in for the kernel)."""
    from super_resolution_tpu_torch.ops import cuda_build

    shift_attn_mask_tensor.cache_clear()
    with torch.inference_mode():
        mask = shift_attn_mask_tensor(16, 16, 8, 4, "cpu")
    assert not mask.is_inference()
    assert shift_attn_mask_tensor(16, 16, 8, 4, "cpu") is mask
    rng = np.random.default_rng(2)
    qkv = torch.from_numpy(rng.standard_normal(
        (1, 16, 16, 48)).astype(np.float32)).requires_grad_()
    bias = torch.zeros((2, 64, 64), requires_grad=True)

    def plain(q, b, m):
        return tca.msa_attention_reference(q, b, m, 2, 8)
    out = cuda_build._PlainBackward.apply(plain, plain, qkv, bias, mask)
    out.square().sum().backward()
    assert qkv.grad is not None and bias.grad is not None
