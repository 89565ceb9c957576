"""The port's real-world runners (runtime/realgan.py) against the JAX
package's on the CPU: the degradation synthesizer and the pair pool for one
seed, multi-step G / D runs of RealHATGANModel, RealHATMSEModel,
RealESRGANModel (LDL) and RealESRNetModel on bridged G, D and VGG weights,
a resumed run against the uninterrupted one, the four shipped real-world
option files through the train pipeline, and the CLI without JAX.

The networks are narrowed: the fork's HAT (embed 24, one RHAG of one HAB,
window 8, x4) and ESCReal (dim 16, one block, window 8, x4); D at
``num_feat`` 16; VGG19 on 32 x 32 crops, its weights a seeded random state
dict under torchvision's names in a temporary .pth that both packages load
(the runs cut it after conv3_4, which halves JAX's compile; the shipped
files' five layers are held in tests/test_torch_gan_parts.py and built and
stepped below).
The noise ranges are 0 and the JPEG qualities fixed, so that the synthesis
is deterministic in both packages (their noise draws differ by design:
ROADMAP.md queue 3).

Tolerances: the synthesized LQ within 1e-5, but for pixels that round to
the next 8-bit level (the last step rounds to 1/255, and a float32
difference of 1e-6 at a level's midpoint moves a pixel there): at most one
level, in at most 0.5 % of pixels. In the runs below the port's synthesizer
runs, is held to that tolerance, and hands on JAX's batch, so that the G
and D steps see the same pixels. The first iteration's losses to 1e-5
relative. Adam's first update is lr times the sign of each gradient entry,
so an entry whose gradient is within rounding of 0 (at the kinks of the L1
losses and the LeakyReLUs) moves by +lr in one package and -lr in the
other; those few weights then move the outputs. So: the later losses to
1e-3 relative (measured: 1.5e-4 at worst), and the G, EMA and D weights
and the spectral-norm ``u`` within lr / 10, as the train tests of the
fork's HAT hold them, but for at most 0.5 % of the entries (measured: 0 in
the HAT run, 0.12 % to 0.17 % in the ESCReal runs), which stay within
2 lr a step. A resumed run repeats the uninterrupted one's operations:
equal.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from super_resolution_tpu_torch.convert.flax_bridge import (
    flax_to_state_dict, sn_stats_to_state_dict)
from super_resolution_tpu_torch.data.degradations import (
    circular_lowpass_kernel, random_mixed_kernels)
from super_resolution_tpu_torch.models.vgg_arch import \
    seeded_vgg19_state_dict
from super_resolution_tpu_torch.runtime import build_model
from super_resolution_tpu_torch.runtime.realgan import (
    DegradationSynthesizer, PairPool, RealHATGANModel)
from torch_threads import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HAT_NET = dict(type="HAT", upscale=4, in_chans=3, img_size=16,
               window_size=8, compress_ratio=3, squeeze_factor=6,
               conv_scale=0.01, overlap_ratio=0.5, img_range=1.0,
               depths=[1], embed_dim=24, num_heads=[2], mlp_ratio=2,
               upsampler="pixelshuffle", resi_connection="1conv")
ESC_REAL_NET = dict(type="ESCReal", dim=16, pdim=8, kernel_size=5,
                    n_blocks=1, conv_blocks=1, window_size=8, num_heads=2,
                    upscaling_factor=4, exp_ratio=1.0)
# the networks' last conv (see _g_weights)
LAST_CONV = {"HAT": "conv_last", "ESCReal": "to_img.8"}
DISC = {"type": "UNetDiscriminatorSN", "num_in_ch": 3, "num_feat": 16,
        "skip_connection": True}
GT, CANVAS, BATCH = 32, 48, 2
# the runners' manual_seed, the synthesizer's seed: one seed everywhere, so
# that JAX compiles each stage's shapes once a file
SEED = 3
LR = 1e-3
ATOL_PARAM = LR / 10
MAX_FLIP_SHARE = 5e-3
RTOL_LOSS = 1e-5
RTOL_LOSS_DRIFT = 1e-3
ATOL_SYNTH = 1e-5
LEVEL = 1 / 255
MAX_LEVEL_SHARE = 0.005
GAN_FILE = "options/train/train_Real_HAT_GAN_SRx4_finetune_from_mse_model.yml"
REAL_FILES = ["options/train/train_Real_HAT_SRx4_mse_model.yml", GAN_FILE,
              "options/esc/train/ESC_Real_X4_MSE.yml",
              "options/esc/train/ESC_Real_X4_GAN.yml"]



def _load_yml(name):
    with open(os.path.join(REPO, name)) as f:
        return yaml.safe_load(f)


def write_vgg19(path, seed=0):
    """A seeded random VGG19 state dict under torchvision's names, with a
    classifier entry, as torchvision's file holds it."""
    torch.save(seeded_vgg19_state_dict(seed), path)
    return str(path)


@pytest.fixture(scope="module")
def vgg_path(tmp_path_factory):
    return write_vgg19(tmp_path_factory.mktemp("vgg") / "vgg19.pth")


def _degradation(opt):
    """The shipped GAN file's degradation with the noise ranges at 0 and
    the JPEG qualities fixed."""
    src = _load_yml(GAN_FILE)
    keys = [k for k in src if k.endswith(("_prob", "_range", "_prob2",
                                          "_range2"))]
    opt.update({k: src[k] for k in keys})
    opt.update(noise_range=[0, 0], noise_range2=[0, 0],
               poisson_scale_range=[0, 0], poisson_scale_range2=[0, 0],
               jpeg_range=[60, 60], jpeg_range2=[85, 85])
    return opt


def _options(model_type, net, vgg, gan=True, **train):
    opt = _degradation({
        "name": "real", "model_type": model_type, "scale": 4, "num_gpu": 1,
        "manual_seed": SEED, "is_train": True, "gt_size": GT,
        "queue_size": 2 * BATCH, "network_g": dict(net),
        "datasets": {"train": {"gt_size": GT}},
        "path": {"pretrain_network_g": None},
        "train": {
            "ema_decay": 0.9,
            "optim_g": {"type": "Adam", "lr": LR, "betas": [0.9, 0.99]},
            "optim_d": {"type": "Adam", "lr": LR, "betas": [0.9, 0.99]},
            "scheduler": {"type": "MultiStepLR", "milestones": [2],
                          "gamma": 0.5},
            "total_iter": 10, "warmup_iter": -1,
            "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0,
                          "reduction": "mean"},
            "perceptual_opt": {
                "type": "PerceptualLoss", "vgg_weights_path": vgg,
                "layer_weights": {"conv1_2": 0.1, "conv2_2": 0.1,
                                  "conv3_4": 1},
                "vgg_type": "vgg19", "use_input_norm": True,
                "perceptual_weight": 1.0, "style_weight": 0,
                "range_norm": False, "criterion": "l1"},
            "net_d_iters": 1, "net_d_init_iters": 0}})
    if gan:
        opt["network_d"] = dict(DISC)
        opt["train"]["gan_opt"] = {"type": "GANLoss", "gan_type": "vanilla",
                                   "real_label_val": 1.0,
                                   "fake_label_val": 0.0, "loss_weight": 0.1}
    opt["train"].update(train)
    return opt


def _batches(n, seed=0):
    """Loader batches of the real-world dataset's form: GT canvases and
    the three kernels of each item, from the shipped file's families."""
    ds = _load_yml(GAN_FILE)["datasets"]["train"]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        gt = rng.random((BATCH, CANVAS, CANVAS, 3)).astype(np.float32)
        gt = 0.25 * (gt + np.roll(gt, 1, 1) + np.roll(gt, 1, 2)
                     + np.roll(gt, (1, 1), (1, 2)))

        def kernels(sfx):
            return np.stack([random_mixed_kernels(
                ds["kernel_list" + sfx], ds["kernel_prob" + sfx], 21,
                ds["blur_sigma" + sfx], ds["blur_sigma" + sfx],
                betag_range=ds["betag_range" + sfx],
                betap_range=ds["betap_range" + sfx], rng=rng)
                for _ in range(BATCH)]).astype(np.float32)

        out.append({"gt": gt, "kernel1": kernels(""),
                    "kernel2": kernels("2"),
                    "sinc_kernel": np.stack([circular_lowpass_kernel(
                        rng.uniform(1.0, 3.0), 21) for _ in range(BATCH)])
                    .astype(np.float32)})
    return out


def assert_synth_close(got, ref):
    """``got`` within :data:`ATOL_SYNTH` of ``ref`` but for pixels one
    8-bit level away, in at most :data:`MAX_LEVEL_SHARE` of them."""
    d = np.abs(np.asarray(got) - np.asarray(ref))
    off = d > ATOL_SYNTH
    assert float(d.max()) <= LEVEL + ATOL_SYNTH, float(d.max())
    assert np.all(np.abs(d[off] - LEVEL) <= ATOL_SYNTH)
    assert off.mean() <= MAX_LEVEL_SHARE, off.mean()


# ------------------------------------------------------------ synthesizer
def test_synthesizer_and_pool_match_jax():
    """Four batches through the synthesizer and a pool of two batches (the
    swap branch from the third on), one seed in both packages: the shapes,
    the branches and the pixels."""
    from super_resolution_tpu.runtime import realgan as jrealgan

    opt = _degradation({"scale": 4, "gt_size": GT})
    jsynth, jpool = jrealgan.DegradationSynthesizer(opt, SEED), \
        jrealgan.PairPool(2 * BATCH, SEED)
    synth = DegradationSynthesizer(opt, SEED, "cpu")
    pool = PairPool(2 * BATCH, SEED)
    for batch in _batches(4):
        args = [batch[k] for k in ("gt", "kernel1", "kernel2",
                                   "sinc_kernel")]
        jlq, jgt = jsynth(*args)
        lq, gt = synth(*[torch.from_numpy(a) for a in args])
        assert lq.shape == (BATCH, GT // 4, GT // 4, 3) == jlq.shape
        assert_synth_close(lq, jlq)
        np.testing.assert_array_equal(gt.numpy(), np.asarray(jgt))
        # the pool on the same pairs: equal
        jplq, jpgt = jpool(jlq, jgt)
        plq, pgt = pool(torch.from_numpy(np.asarray(jlq)),
                        torch.from_numpy(np.asarray(jgt)))
        np.testing.assert_array_equal(plq.numpy(), np.asarray(jplq))
        np.testing.assert_array_equal(pgt.numpy(), np.asarray(jpgt))
        np.testing.assert_allclose(synth.sharpen(pgt).numpy(),
                                   np.asarray(jsynth.sharpen(jpgt)),
                                   atol=ATOL_SYNTH)
    assert pool.ptr == 2 * BATCH
    assert synth.rng.bit_generator.state == jsynth.rng.bit_generator.state


# ------------------------------------------------------------- the steps
class _PinnedSynth:
    """The port's synthesizer, held to JAX's output of the same call, which
    it then returns: the runs below compare the steps on the same pixels."""

    def __init__(self, synth, ref: list):
        self.synth, self.ref = synth, ref

    def __call__(self, *args, **kw):
        lq, gt = self.synth(*args, **kw)
        jlq, jgt = self.ref.pop(0)
        assert_synth_close(lq, jlq)
        np.testing.assert_allclose(gt.numpy(), np.asarray(jgt),
                                   atol=ATOL_SYNTH)
        return torch.from_numpy(np.array(jlq)), torch.from_numpy(
            np.array(jgt))

    def __getattr__(self, name):
        return getattr(self.synth, name)


def _g_weights(net):
    """The port's seeded weights, every all-zero tensor made small and
    random (so each branch moves), the RPB widened, and the JAX tree of the same weights
    (its shapes from ``jax.eval_shape``)."""
    from super_resolution_tpu.convert.torch_import import convert_state_dict
    from super_resolution_tpu.models import build_network as j_build
    from super_resolution_tpu_torch.models import build_network
    from super_resolution_tpu_torch.models.arch_util import init_weights

    tnet = build_network(net)
    init_weights(tnet, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    sd = {}
    for k, v in tnet.state_dict().items():
        if "relative_position_bias" in k:
            # widened, as the ESC train tests widen it: a near-uniform
            # attention's bias gradient is a small residue of cancelling
            # terms, whose rounding Adam's normalisation magnifies
            v = v * 500.0
        elif v.is_floating_point() and not v.any():
            v = torch.from_numpy((rng.standard_normal(tuple(v.shape)) * 0.05)
                                 .astype(np.float32))
        sd[k] = v
    # the last conv scaled so that the output spreads like an image about
    # 0.5 (std 0.2): on a near-constant output the VGG's max-pools choose
    # between values equal to within rounding, and the two packages route
    # the perceptual gradient to different pixels
    tnet.load_state_dict(sd)
    with torch.no_grad():
        out = tnet(torch.from_numpy(rng.random((2, 16, 16, 3))
                                    .astype(np.float32)))
    last = LAST_CONV[net["type"]]
    sd[last + ".weight"] = sd[last + ".weight"] * (0.2 / float(out.std()))
    sd[last + ".bias"] = torch.full_like(sd[last + ".bias"], 0.5)
    shapes = jax.eval_shape(lambda: j_build(net).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))["params"])
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    return sd, convert_state_dict({k: v.numpy() for k, v in sd.items()},
                                  template, strict=True)


@pytest.fixture(scope="module")
def g_weights():
    return {"hat": _g_weights(HAT_NET), "esc_real": _g_weights(ESC_REAL_NET)}


def _runners(opt, weights, monkeypatch):
    """The JAX runner (its flax init of G replaced by the bridged weights;
    D keeps its own init, which the port's D loads) and the port's runner
    on the same weights, both set up for training."""
    from super_resolution_tpu.runtime import build_model as j_build_model
    from super_resolution_tpu.runtime import sr_model as j_sr_model

    sd, params = weights
    monkeypatch.setattr(j_sr_model.SRModel, "_init_params",
                        lambda self: None)
    jmodel = j_build_model(opt)
    jmodel.params = jax.tree_util.tree_map(jnp.asarray, params)
    jmodel.setup_training()
    model = build_model(opt, "cpu")
    model.net_g.load_state_dict(sd, strict=True)
    if model.net_d is not None:
        dsd = flax_to_state_dict(jax.device_get(jmodel.params_d),
                                 model.net_d)
        dsd.update(sn_stats_to_state_dict(jax.device_get(jmodel.sn_stats)))
        model.net_d.load_state_dict(dsd, strict=True)
    model.setup_training()
    return jmodel, model


def _run_both(jmodel, model, batches):
    """Each iteration of both runners through ``optimize_parameters``; the
    port's synthesizer pinned to JAX's output. Returns both logs."""
    ref_pairs = []
    jsynth = jmodel.synth.__call__

    def record(*args, **kw):
        out = jsynth(*args, **kw)
        ref_pairs.append(out)
        return out

    jmodel.synth = _Recorder(jmodel.synth, record)
    model.synth = _PinnedSynth(model.synth, ref_pairs)
    ref, got = [], []
    for it, batch in enumerate(batches, start=1):
        jmodel.optimize_parameters(batch, it)
        ref.append(jmodel.get_current_log())
        model.optimize_parameters(batch, it)
        got.append(model.get_current_log())
    return ref, got


class _Recorder:
    """JAX's synthesizer with its calls recorded."""

    def __init__(self, synth, call):
        self.synth, self.call = synth, call

    def __call__(self, *args, **kw):
        return self.call(*args, **kw)

    def __getattr__(self, name):
        return getattr(self.synth, name)


def _diffs(got: dict, ref: dict):
    return torch.cat([(got[k].float() - ref[k].float()).abs().flatten()
                      for k in ref])


def _assert_params(net, flax_params, steps: int):
    """All but :data:`MAX_FLIP_SHARE` of the weights within ATOL_PARAM,
    every one within the flips' bound 2 lr a step."""
    d = _diffs(net.state_dict(), flax_to_state_dict(
        jax.device_get(flax_params), net))
    share = float((d > ATOL_PARAM).float().mean())
    assert share <= MAX_FLIP_SHARE, share
    assert float(d.max()) <= 2 * LR * steps, float(d.max())


CASES = {
    "gan_hat": ("RealHATGANModel", "hat", {}, 3),
    # G gated off in iteration 1 (net_d_init_iters 1): the EMA decays, D
    # steps; then three iterations of G and D
    "gan_esc_real_gated": ("RealHATGANModel", "esc_real",
                           dict(net_d_init_iters=1), 4),
    "mse_esc_real": ("RealHATMSEModel", "esc_real", {}, 3),
    "esrgan_ldl": ("RealESRGANModel", "esc_real", dict(ldl_opt={
        "type": "L1Loss", "loss_weight": 1.0, "reduction": "mean"}), 3),
    "esrnet": ("RealESRNetModel", "esc_real", {}, 3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_steps_match_jax_runner(case, g_weights, vgg_path, monkeypatch):
    model_type, net, train, n = CASES[case]
    gan = model_type in ("RealHATGANModel", "RealESRGANModel")
    opt = _options(model_type, HAT_NET if net == "hat" else ESC_REAL_NET,
                   vgg_path, gan=gan, **train)
    jmodel, model = _runners(opt, g_weights[net], monkeypatch)
    ref, got = _run_both(jmodel, model, _batches(n))
    assert [sorted(g) for g in got] == [sorted(r) for r in ref]
    for key in got[0]:
        np.testing.assert_allclose(got[0][key], ref[0][key], rtol=RTOL_LOSS,
                                   err_msg=key)
    for key in got[-1]:
        np.testing.assert_allclose([g[key] for g in got if key in g],
                                   [r[key] for r in ref if key in r],
                                   rtol=RTOL_LOSS_DRIFT, err_msg=key)
    _assert_params(model.net_g, jmodel.state.params, n)
    _assert_params(model.state.ema, jmodel.state.ema_params, n)
    sd = g_weights[net][0]
    moved = max(float((model.net_g.state_dict()[k] - v).abs().max())
                for k, v in sd.items() if v.is_floating_point())
    assert moved > 20 * ATOL_PARAM, moved
    if gan:
        _assert_params(model.net_d, jmodel.params_d, n)
        sn = sn_stats_to_state_dict(jax.device_get(jmodel.sn_stats))
        d = _diffs(model.net_d.state_dict(), sn)
        assert float(d.max()) <= ATOL_PARAM, float(d.max())
        assert "l_d_real" in got[-1] and "l_g_gan" in got[-1]
    if case == "gan_esc_real_gated":
        assert "l_g_total" not in got[0] and "l_d_fake" in got[0]
        assert model.state.step == n - 1
    if case == "esrgan_ldl":
        assert got[-1]["l_g_ldl"] > 0


def test_ldl_without_ema_raises(vgg_path):
    opt = _options("RealESRGANModel", ESC_REAL_NET, vgg_path,
                   ema_decay=0, ldl_opt={"type": "L1Loss"})
    model = build_model(opt, "cpu")
    with pytest.raises(ValueError, match="ema_decay"):
        model.setup_training()


def test_spectral_norm_moves_three_times_an_iteration(vgg_path):
    """G's fake pass, D's real pass and D's fake pass each store a new
    ``u``: one iteration equals three stored power iterations on the
    weights D had during them."""
    opt = _options("RealHATGANModel", ESC_REAL_NET, vgg_path)
    model = build_model(opt, "cpu")
    model.setup_training()
    calls = []
    conv = model.net_d.conv1
    forward = type(conv).forward

    def spy(self, x, update_stats=False):
        if self is conv:
            calls.append(update_stats)
        return forward(self, x, update_stats)

    type(conv).forward = spy
    try:
        model.optimize_parameters(_batches(1)[0], 1)
    finally:
        type(conv).forward = forward
    assert calls == [True, True, True]


# ------------------------------------------------------------------ resume
def test_resume_repeats_the_uninterrupted_run(tmp_path, vgg_path):
    """Four iterations, against two, a checkpoint, a new runner resumed
    from it and two more: G, EMA, D with its ``u``, both optimizers, the
    pool and the synthesizer's generators equal (the noise on, so the
    generator's state matters)."""
    opt = _options("RealHATGANModel", ESC_REAL_NET, vgg_path)
    opt.update(noise_range=[1, 30], poisson_scale_range2=[0.05, 2.5],
               jpeg_range=[30, 95])
    opt["path"]["models"] = str(tmp_path)
    batches = _batches(4)

    def fresh():
        m = build_model(opt, "cpu")
        m.setup_training()
        return m

    whole = fresh()
    for it, b in enumerate(batches, start=1):
        whole.optimize_parameters(b, it)
    first = fresh()
    for it, b in enumerate(batches[:2], start=1):
        first.optimize_parameters(b, it)
    first.save(0, 2)
    resumed = fresh()
    assert resumed.resume_training(str(tmp_path / "net_g_2")) == (0, 2)
    for it, b in enumerate(batches[2:], start=3):
        resumed.optimize_parameters(b, it)
    for a, b in ((whole.net_g, resumed.net_g),
                 (whole.state.ema, resumed.state.ema),
                 (whole.net_d, resumed.net_d)):
        for k, v in a.state_dict().items():
            torch.testing.assert_close(b.state_dict()[k], v, rtol=0, atol=0)
    assert whole.get_current_log() == resumed.get_current_log()
    torch.testing.assert_close(resumed.pool.lq, whole.pool.lq, rtol=0,
                               atol=0)
    assert (resumed.synth.rng.bit_generator.state
            == whole.synth.rng.bit_generator.state)
    assert torch.equal(resumed.synth.generator.get_state(),
                       whole.synth.generator.get_state())


# --------------------------------------------- the shipped files, the CLI
def _write_gt(root, n=3, size=CANVAS + 8):
    import cv2

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(11)
    for i in range(n):
        img = (rng.random((size, size - 4 * i, 3)) * 255).astype(np.uint8)
        cv2.imwrite(os.path.join(root, f"{i:04d}.png"), img)
    return str(root)


def _narrowed(name, root, vgg, total_iter=1):
    """A shipped real-world file as shipped but for: the network narrowed
    (G as above, D at num_feat 16), batch 2, gt_size 32 on a 48 canvas, a
    queue of two batches, the data on synthetic GT images, no pretrained
    G, the VGG .pth, total_iter and the logger's frequencies."""
    opt = _load_yml(name)
    net = HAT_NET if opt["network_g"]["type"] == "HAT" else ESC_REAL_NET
    opt["network_g"] = dict(net)
    if "network_d" in opt:
        opt["network_d"]["num_feat"] = 16
    train = opt["datasets"]["train"]
    train.update(dataroot_gt=_write_gt(os.path.join(root, "gt")),
                 batch_size_per_gpu=BATCH, gt_size=GT, crop_pad_size=CANVAS)
    opt["datasets"] = {"train": train}
    opt.update(gt_size=GT, queue_size=2 * BATCH)
    opt["path"] = {"pretrain_network_g": None,
                   "experiments_root": os.path.join(root, "exp"),
                   "resume_state": None}
    if opt["train"].get("perceptual_opt"):
        opt["train"]["perceptual_opt"]["vgg_weights_path"] = vgg
    opt["train"]["total_iter"] = total_iter
    opt["logger"] = {"print_freq": 1, "save_checkpoint_freq": 100,
                     "use_tb_logger": False}
    opt.pop("val", None)
    return opt


@pytest.mark.parametrize("name", REAL_FILES)
def test_shipped_real_file_builds_and_steps(name, tmp_path, vgg_path):
    from super_resolution_tpu_torch.runtime.train_pipeline import run_train
    from super_resolution_tpu_torch.utils.options import process_options

    opt = process_options(_narrowed(name, str(tmp_path), vgg_path),
                          str(tmp_path), is_train=True)
    model, it = run_train(opt, device="cpu")
    assert it == 1 and type(model).__name__ == _load_yml(name)["model_type"]
    logs = model.get_current_log()
    assert logs and all(np.isfinite(v) for v in logs.values())
    assert ("l_d_real" in logs) == ("network_d" in opt)
    assert model.lq.shape == (BATCH, GT // 4, GT // 4, 3)


def test_train_cli_real_file_runs_without_jax(tmp_path, vgg_path):
    """``python -m super_resolution_tpu_torch.train -opt <yml> --device cpu``
    on the shipped Real-HAT GAN file (narrowed) trains two iterations and
    imports no JAX (``-X importtime`` lists every module it imported)."""
    opt = _narrowed(GAN_FILE, str(tmp_path), vgg_path, total_iter=2)
    yml = tmp_path / "real.yml"
    yml.write_text(yaml.safe_dump(opt))
    r = subprocess.run([sys.executable, "-X", "importtime", "-m",
                        "super_resolution_tpu_torch.train", "-opt", str(yml),
                        "--device", "cpu"],
                       capture_output=True, text=True, timeout=300,
                       cwd=str(tmp_path),
                       env={"PYTHONPATH": REPO, "PATH": "",
                            "HOME": str(tmp_path)})
    assert r.returncode == 0, r.stderr[-3000:]
    imported = [line.rsplit("|", 1)[-1].strip()
                for line in r.stderr.splitlines()
                if line.startswith("import time:")]
    assert "super_resolution_tpu_torch.runtime.realgan" in imported
    bad = [m for m in imported if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "super_resolution_tpu")]
    assert not bad, bad
    log = open(os.path.join(tmp_path, "exp", opt["name"],
                            f"train_{opt['name']}.log")).read()
    assert "l_g_gan:" in log and "End of training." in log


def test_runner_without_a_card_raises():
    """Runners default to the card: built where there is none, one raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    opt = _options("RealHATMSEModel", ESC_REAL_NET, None, gan=False)
    del opt["train"]["perceptual_opt"]
    with pytest.raises((RuntimeError, AssertionError)):
        build_model(opt)
    assert RealHATGANModel.__init__.__defaults__ == ("cuda",)
