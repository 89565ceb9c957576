"""The face runners' parts on the CPU against the JAX package: the GAN
penalties and the feature-matching loss, ``FFHQDataset`` (disk and LMDB),
the first iteration of ``StyleGAN2Model`` (R1 and the path penalty firing)
and of ``HiFaceGANModel``, JAX's ``train_pipeline`` on a StyleGAN2 option
file (it fails: the runner has no ``setup_training``) against the port's,
and a subprocess that imports no JAX.

Small config: StyleGAN2 at out_size 16, 16-dim styles, narrow 1/32, batch
4; HiFaceGAN at 4 features on 64 x 64 faces, D at 4 features, 2 scales, 3
layers, VGG19 cut after conv2_2 on a seeded random state dict. The
spectral-norm vectors are the power iteration's (``converge_sn``).

The same draws go to both packages: the port's runner takes them as
arguments (``train_iteration``), and JAX's steps get the same styles and
inject indices, and ``jax.random.normal`` is patched to hand out the same
per-layer and path noises (JAX draws them from keys inside its jitted
steps). Tolerances: float32, summation order only. The penalties to 1e-4
relative, ``GANFeatLoss`` 1e-6; losses to 1e-4 relative; weights after the
iteration within lr / 10 but for at most 0.5 % of the entries, each within
2 lr (Adam's first update is lr times a gradient's sign, and a gradient
within rounding of 0 can take the other sign).
"""

import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from flax_weights import converge_sn, random_params
from torch_threads import few_torch_threads  # noqa: F401

from super_resolution_tpu_torch.convert.flax_bridge import flax_to_state_dict
from super_resolution_tpu_torch.data import build_dataset
from super_resolution_tpu_torch.losses.gan import (GANFeatLoss,
                                                   g_path_regularize,
                                                   gradient_penalty_loss,
                                                   r1_penalty)
from super_resolution_tpu_torch.models import build_network
from super_resolution_tpu_torch.models.vgg_arch import \
    seeded_vgg19_state_dict
from super_resolution_tpu_torch.runtime import build_model
from super_resolution_tpu_torch.runtime.train_pipeline import train_from_yaml
from super_resolution_tpu_torch.utils.lmdb_util import make_lmdb_from_imgs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-4
SG_G = dict(type="StyleGAN2Generator", out_size=16, num_style_feat=16,
            num_mlp=2, channel_multiplier=1, narrow=1 / 32)
SG_D = dict(type="StyleGAN2Discriminator", out_size=16, channel_multiplier=1,
            narrow=1 / 32)
SG_LR = 2e-3
HF_LR = 1e-4
HF_G = dict(type="HiFaceGAN", num_feat=4)
HF_D = dict(type="HiFaceGANDiscriminator", num_feat=4, num_d=2, n_layers_d=3)
# HiFaceGAN's modules its forward does not call: no flax leaves
HF_UNUSED = ("fc.", "to_rgbs.0.", "to_rgbs.1.", "to_rgbs.2.")
MAX_FLIP_SHARE = 0.005


def _jparams(jmod, rng, *args, **kw):
    shapes = jax.eval_shape(lambda: jmod.init(
        jax.random.PRNGKey(0), *(jnp.asarray(a) for a in args), **kw))
    return converge_sn(random_params(shapes["params"], rng), rng)


def _close(got, want):
    for k, v in want.items():
        np.testing.assert_allclose(got[k], float(v), rtol=RTOL, atol=1e-6,
                                   err_msg=k)


def _weights_close(net, jparams, lr, keep=()):
    ref = flax_to_state_dict(jax.device_get(jparams), net, keep=keep)
    own = net.state_dict()
    d = torch.cat([(own[k] - v).abs().flatten() for k, v in ref.items()
                   if not k.startswith(keep)])
    assert float((d > lr / 10).float().mean()) <= MAX_FLIP_SHARE
    assert float(d.max()) <= 2 * lr


# ---------------------------------------------------------------- penalties
def _disc(rng):
    from super_resolution_tpu.models.stylegan2_arch import \
        StyleGAN2Discriminator as JD

    cfg = {k: v for k, v in SG_D.items() if k != "type"}
    x = rng.standard_normal((4, 16, 16, 3)).astype(np.float32)
    jd, td = JD(**cfg), build_network(SG_D)
    params = _jparams(jd, rng, x)
    td.load_state_dict(flax_to_state_dict(params, td), strict=True)
    return (lambda v: jd.apply({"params": params}, v)), td, x


def test_r1_penalty_matches_jax(rng):
    from super_resolution_tpu.losses.gan import r1_penalty as j_r1

    jfn, td, x = _disc(rng)
    want = float(jax.jit(lambda v: j_r1(jfn, v))(jnp.asarray(x)))
    real = torch.from_numpy(x).requires_grad_(True)
    got = r1_penalty(td(real), real)
    assert got.requires_grad and want > 0
    np.testing.assert_allclose(float(got), want, rtol=RTOL)


def test_gradient_penalty_matches_jax(rng):
    from super_resolution_tpu.losses.gan import \
        gradient_penalty_loss as j_gp

    jfn, td, real = _disc(rng)
    fake = rng.standard_normal(real.shape).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = float(jax.jit(lambda a, b: j_gp(jfn, a, b, key))(
        jnp.asarray(real), jnp.asarray(fake)))
    alpha = np.asarray(jax.random.uniform(key, (4, 1, 1, 1)))
    got = gradient_penalty_loss(td, torch.from_numpy(real),
                                torch.from_numpy(fake),
                                alpha=torch.from_numpy(alpha))
    np.testing.assert_allclose(float(got), want, rtol=RTOL)


def test_g_path_regularize_matches_jax(rng):
    """The path penalty of a decode from latents, the same noise handed
    to both: the penalty, the mean path length and its update."""
    from super_resolution_tpu.losses.gan import \
        g_path_regularize as j_path
    from super_resolution_tpu.models.stylegan2_arch import \
        StyleGAN2Generator as JG

    cfg = {k: v for k, v in SG_G.items() if k != "type"}
    z = rng.standard_normal((2, 16)).astype(np.float32)
    jg, tg = JG(**cfg), build_network(SG_G)
    params = _jparams(jg, rng, [z], randomize_noise=False)
    tg.load_state_dict(flax_to_state_dict(params, tg), strict=True)
    lat = rng.standard_normal((2, tg.num_latent, 16)).astype(np.float32)
    key = jax.random.PRNGKey(7)

    def decode(lt):
        return jg.apply({"params": params}, [lt], input_is_latent=True,
                        randomize_noise=False)[0]

    want = jax.jit(lambda lt: j_path(decode, lt, jnp.asarray(0.5), key))(
        jnp.asarray(lat))
    noise = np.asarray(jax.random.normal(key, (2, 16, 16, 3)))
    latents = torch.from_numpy(lat).requires_grad_(True)
    fake, _ = tg([latents], input_is_latent=True, randomize_noise=False)
    got = g_path_regularize(fake, latents, torch.tensor(0.5),
                            noise=torch.from_numpy(noise))
    assert got[0].requires_grad
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=RTOL)


def test_gan_feat_loss_matches_jax(rng):
    from super_resolution_tpu.losses.gan import GANFeatLoss as JFeat

    shapes = [[(2, 8, 8, 4), (2, 4, 4, 8), (2, 3, 3, 1)],
              [(2, 4, 4, 4), (2, 2, 2, 8), (2, 2, 2, 1)]]
    fake = [[rng.standard_normal(s).astype(np.float32) for s in d]
            for d in shapes]
    real = [[rng.standard_normal(s).astype(np.float32) for s in d]
            for d in shapes]
    for crit in ("l1", "l2", "charbonnier"):
        want = JFeat(crit, loss_weight=10.0)(
            [[jnp.asarray(a) for a in d] for d in fake],
            [[jnp.asarray(a) for a in d] for d in real])
        got = GANFeatLoss(crit, loss_weight=10.0)(
            [[torch.from_numpy(a) for a in d] for d in fake],
            [[torch.from_numpy(a) for a in d] for d in real])
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ------------------------------------------------------------------ dataset
@pytest.fixture(scope="module")
def faces(tmp_path_factory):
    """Eight 16 x 16 PNG faces, on disk and in an LMDB."""
    rng = np.random.default_rng(4)
    root = tmp_path_factory.mktemp("ffhq")
    folder = root / "ffhq"
    folder.mkdir()
    names = [f"{i:08d}.png" for i in range(8)]
    for n in names:
        cv2.imwrite(str(folder / n),
                    (rng.random((16, 16, 3)) * 255).astype(np.uint8))
    lmdb = str(root / "ffhq.lmdb")
    make_lmdb_from_imgs(str(folder), lmdb, names, [n[:-4] for n in names])
    return {"disk": str(folder), "lmdb": lmdb}


def _ffhq_opt(faces, backend, **kw):
    return dict({"name": "FFHQ", "type": "FFHQDataset",
                 "dataroot_gt": faces[backend], "io_backend": {
                     "type": backend}, "use_hflip": True,
                 "mean": [0.5, 0.4, 0.3], "std": [0.5, 0.6, 0.7]}, **kw)


@pytest.mark.parametrize("backend", ["disk", "lmdb"])
def test_ffhq_dataset_matches_jax(backend, faces):
    """Items for a seed (the flips drawn in JAX's order), and the
    ``num_imgs`` path list."""
    from super_resolution_tpu.data import build_dataset as j_build_dataset

    opt = _ffhq_opt(faces, backend)
    ours, theirs = build_dataset(dict(opt)), j_build_dataset(dict(opt))
    assert len(ours) == len(theirs) == 8
    ours.seed(5)
    theirs.seed(5)
    for i in (0, 3, 3, 7, 1):
        a, b = ours[i], theirs[i]
        assert a["gt_path"] == b["gt_path"]
        np.testing.assert_array_equal(a["gt"], np.asarray(b["gt"]))
    if backend == "disk":
        opt["num_imgs"] = 3
        assert build_dataset(opt).paths == j_build_dataset(opt).paths


# ------------------------------------------------------------------ runners
def _sg_opt(root=None, **train):
    opt = {"name": "sg2", "model_type": "StyleGAN2Model", "is_train": True,
           "manual_seed": 0, "num_gpu": 1, "network_g": dict(SG_G),
           "network_d": dict(SG_D),
           "path": {"pretrain_network_g": None},
           "train": dict({
               "optim_g": {"type": "Adam", "lr": SG_LR},
               "optim_d": {"type": "Adam", "lr": SG_LR},
               "gan_opt": {"type": "GANLoss", "gan_type": "wgan_softplus",
                           "loss_weight": 1},
               "r1_reg_weight": 10, "path_reg_weight": 2,
               "net_g_reg_every": 2, "net_d_reg_every": 2,
               "mixing_prob": 0.9, "path_batch_shrink": 2}, **train),
           "val": {"num_val_samples": 4}}
    if root is not None:
        opt["path"].update(models=str(root / "models"),
                           visualization=str(root / "vis"))
    return opt


def _jit_sg_inits(monkeypatch):
    """JAX's StyleGAN2 runner's flax inits in one compiled call each, not
    op by op (eagerly they take seconds)."""
    from super_resolution_tpu.models import stylegan2_arch as jsg

    for cls in (jsg.StyleGAN2Generator, jsg.StyleGAN2Discriminator):
        monkeypatch.setattr(cls, "init", (
            lambda flax_init: lambda self, key, v: jax.jit(
                lambda k, vv: flax_init(self, k, vv))(key, v))(cls.init))


def test_stylegan2_first_iteration_matches_jax(rng, monkeypatch, tmp_path):
    """Iteration 2 (R1 and the path penalty both fire) on the same weights
    and draws: every loss and score, the new mean path length, G, D and
    the EMA after it; then the grid of samples and a save / resume."""
    from super_resolution_tpu.runtime import build_model as j_build_model

    _jit_sg_inits(monkeypatch)
    opt = _sg_opt(tmp_path)
    jm = j_build_model(dict(opt))
    model = build_model(opt, "cpu")
    gp = converge_sn(random_params(jm.params, rng), rng)
    dp = random_params(jm.params_d, rng)
    jm.params, jm.params_d = gp, dp
    jm.ema_params = jax.tree_util.tree_map(jnp.copy, gp)
    jm.opt_state_g, jm.opt_state_d = jm.tx_g.init(gp), jm.tx_d.init(dp)
    for net in (model.net_g, model.net_g_ema):
        net.load_state_dict(flax_to_state_dict(gp, net), strict=True)
    model.net_d.load_state_dict(flax_to_state_dict(dp, model.net_d),
                                strict=True)

    b, pb, n = 4, 2, model.num_layers
    res = [2 ** ((i + 5) // 2) for i in range(n)]
    table = {(bb, r, r, 1): rng.standard_normal((bb, r, r, 1)).astype(
        np.float32) for bb in (b, pb) for r in res}
    table[(pb, 16, 16, 3)] = rng.standard_normal((pb, 16, 16, 3)).astype(
        np.float32)
    normal = jax.random.normal

    def same_noise(key, shape=(), dtype=jnp.float32):
        shape = tuple(shape)
        if shape in table:
            return jnp.asarray(table[shape], dtype)
        return normal(key, shape, dtype)

    monkeypatch.setattr(jax.random, "normal", same_noise)

    def z(bb):
        return rng.standard_normal((bb, 16)).astype(np.float32)

    parts = {"d": ([z(b), z(b)], 2, b), "g": ([z(b)], None, b),
             "path": ([z(pb), z(pb)], 4, pb)}
    draws = {k: {"styles": [torch.from_numpy(s) for s in st],
                 "inject": inj,
                 "noise": [torch.from_numpy(np.ascontiguousarray(
                     table[(bb, r, r, 1)].transpose(0, 3, 1, 2)))
                     for r in res]}
             for k, (st, inj, bb) in parts.items()}
    draws["path"]["path_noise"] = torch.from_numpy(table[(pb, 16, 16, 3)])
    real = rng.standard_normal((b, 16, 16, 3)).astype(np.float32)

    def js(k):
        st, inj, _ = parts[k]
        return ([jnp.asarray(s) for s in st],
                None if inj is None else jnp.asarray(inj))

    key = jax.random.PRNGKey(0)
    logs = {}
    styles, inject = js("d")
    jm.params_d, jm.opt_state_d, d_logs = jm._d_step(
        jm.params_d, jm.opt_state_d, jm.params, jnp.asarray(real), styles,
        key, inject, True, jm.r1_reg_weight, jm.net_d_reg_every)
    logs.update(d_logs)
    jm.params, jm.opt_state_g, g_logs = jm._g_step(
        jm.params, jm.opt_state_g, jm.params_d, js("g")[0], key, None)
    logs.update(g_logs)
    styles, inject = js("path")
    jm.params, jm.opt_state_g, mean, p_logs = jm._g_reg_step(
        jm.params, jm.opt_state_g, styles, jm.mean_path_length, key, key,
        inject)
    logs.update(p_logs)
    jm.ema_params = jax.tree_util.tree_map(
        lambda e, p: e * jm.ema_decay + p * (1 - jm.ema_decay),
        jm.ema_params, jm.params)

    model.feed_data({"gt": real})
    model.train_iteration(draws, 2)
    got = model.get_current_log()
    assert set(got) == set(logs) >= {"l_d", "l_d_r1", "l_g", "l_g_path",
                                     "path_length"}
    _close(got, logs)
    np.testing.assert_allclose(float(model.mean_path_length), float(mean),
                               rtol=RTOL)
    lr_g = SG_LR * 2 / 3
    _weights_close(model.net_g, jm.params, lr_g)
    _weights_close(model.net_d, jm.params_d, lr_g)
    _weights_close(model.net_g_ema, jm.ema_params, lr_g)

    model.nondist_validation(None, 2)
    img = cv2.imread(str(tmp_path / "vis" / "train" / "train_2.png"))
    assert img.shape == (16, 64, 3)
    model.save(0, 2)
    again = build_model(opt, "cpu")
    assert again.resume_training(str(tmp_path / "models" / "net_g_2")) == (
        0, 2)
    for a, c in ((again.net_g, model.net_g), (again.net_d, model.net_d),
                 (again.net_g_ema, model.net_g_ema)):
        for k, v in a.state_dict().items():
            assert torch.equal(v, c.state_dict()[k]), k
    assert torch.equal(again.mean_path_length, model.mean_path_length)


def test_hifacegan_first_iteration_matches_jax(rng, monkeypatch, tmp_path):
    """One iteration (G, then D on G's output before the update) on the
    same weights: every loss, and G and D after it."""
    from super_resolution_tpu.models import hifacegan_arch as jh
    from super_resolution_tpu.runtime import build_model as j_build_model
    from super_resolution_tpu.runtime import sr_model as j_sr_model

    vgg = str(tmp_path / "vgg19.pth")
    torch.save(seeded_vgg19_state_dict(0), vgg)
    opt = {"name": "hifacegan", "model_type": "HiFaceGANModel", "scale": 1,
           "is_train": True, "manual_seed": 0, "num_gpu": 1,
           "network_g": dict(HF_G), "network_d": dict(HF_D),
           "path": {"pretrain_network_g": None},
           "train": {
               "optim_g": {"type": "Adam", "lr": HF_LR, "betas": [0.5, 0.999]},
               "optim_d": {"type": "Adam", "lr": HF_LR, "betas": [0.5, 0.999]},
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
    x = rng.random((2, 64, 64, 3), dtype=np.float32)
    gp = _jparams(jh.HiFaceGAN(num_feat=4), rng, x)
    monkeypatch.setattr(j_sr_model.SRModel, "_init_params",
                        lambda self: None)
    flax_init = jh.HiFaceGANDiscriminator.init
    monkeypatch.setattr(jh.HiFaceGANDiscriminator, "init",
                        lambda self, key, v: jax.jit(
                            lambda k, vv: flax_init(self, k, vv))(key, v))
    jm = j_build_model(dict(opt))
    jm.params = jax.tree_util.tree_map(jnp.asarray, gp)
    jm.setup_training()
    dp = converge_sn(random_params(jm.params_d, rng), rng)
    jm.params_d, jm.opt_state_d = dp, jm.tx_d.init(dp)

    model = build_model(opt, "cpu")
    model.net_g.load_state_dict(flax_to_state_dict(gp, model.net_g,
                                                   keep=HF_UNUSED))
    model.setup_training()
    model.net_d.load_state_dict(flax_to_state_dict(dp, model.net_d),
                                strict=True)
    batch = {"lq": x, "gt": rng.random((2, 64, 64, 3), dtype=np.float32)}
    jm.optimize_parameters(batch, 1)
    model.optimize_parameters(batch, 1)
    want = jm.get_current_log()
    assert set(model.get_current_log()) == set(want) >= {
        "l_g_pix", "l_g_percep", "l_g_gan", "l_g_feat", "l_g_total",
        "l_d_real", "l_d_fake"}
    _close(model.get_current_log(), want)
    _weights_close(model.net_g, jm.state.params, HF_LR, keep=HF_UNUSED)
    _weights_close(model.net_d, jm.params_d, HF_LR)


# ---------------------------------------------------------------- pipelines
def _sg_yml(faces, root, name, total_iter):
    opt = _sg_opt(total_iter=total_iter)
    opt.update(name=name, datasets={"train": _ffhq_opt(
        faces, "disk", batch_size_per_gpu=4, dataset_enlarge_ratio=1,
        mean=[0.5] * 3, std=[0.5] * 3)},
        logger={"print_freq": 1, "save_checkpoint_freq": 2,
                "use_tb_logger": False})
    opt["path"]["experiments_root"] = str(root)
    del opt["is_train"]
    path = root / f"{name}.yml"
    path.write_text(yaml.safe_dump(opt))
    return str(path)


def test_stylegan2_file_fails_in_jax_train_pipeline_runs_in_port(
        faces, tmp_path, monkeypatch):
    """JAX's ``train_pipeline`` calls ``model.setup_training``, which JAX's
    ``StyleGAN2Model`` lacks (ROADMAP.md queue 3); the port's runs the
    same file: iteration 2 fires both penalties and saves ``net_g_2``."""
    from super_resolution_tpu.runtime.train_pipeline import \
        train_from_yaml as j_train_from_yaml

    _jit_sg_inits(monkeypatch)
    with pytest.raises(AttributeError, match="setup_training"):
        j_train_from_yaml(_sg_yml(faces, tmp_path, "jax_sg2", 2),
                          str(tmp_path))
    model, last = train_from_yaml(_sg_yml(faces, tmp_path, "sg2", 2),
                                  str(tmp_path), device="cpu")
    logs = model.get_current_log()
    assert last == 2 and {"l_d_r1", "l_g_path"} <= set(logs)
    assert np.isfinite(list(logs.values())).all()
    assert os.listdir(tmp_path / "sg2" / "models") == ["net_g_2"]


def test_face_stack_imports_no_jax(faces, tmp_path):
    """In a fresh interpreter: every new network builds and runs a small
    forward, and ``train.py`` runs one StyleGAN2 iteration on the CPU; no
    module of JAX, flax or the JAX package is loaded."""
    yml = _sg_yml(faces, tmp_path, "sg2_cli", 1)
    script = f"""
import sys, torch
from super_resolution_tpu_torch.models import build_network
from super_resolution_tpu_torch.models.inception_arch import FIDInceptionV3
from super_resolution_tpu_torch.train import train_pipeline
with torch.no_grad():
    z = [torch.randn(2, 16)]
    for t in ("StyleGAN2Generator", "StyleGAN2GeneratorBilinear"):
        g = build_network(dict({SG_G!r}, type=t))
        assert g(z)[0].shape == (2, 16, 16, 3)
    assert build_network({SG_D!r})(torch.randn(4, 16, 16, 3)).shape == (4, 1)
    x = torch.rand(1, 64, 64, 3)
    assert build_network({HF_G!r})(x).shape == x.shape
    d = build_network({HF_D!r})(torch.cat([x, x], -1))
    assert len(d) == 2 and len(d[0]) == 4
    build_network(dict(type="DFDNet", num_feat=64))
    assert FIDInceptionV3()(torch.rand(1, 75, 75, 3))[0].shape == (
        1, 2048, 1, 1)
train_pipeline(".", argv=["-opt", {yml!r}, "--device", "cpu"])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                    "super_resolution_tpu"))
print("FOREIGN", bad)
"""
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=300, cwd=str(tmp_path),
                       env={"PYTHONPATH": REPO, "PATH": "",
                            "HOME": str(tmp_path)})
    assert r.returncode == 0, r.stderr[-3000:]
    assert "FOREIGN []" in r.stdout
    log = (tmp_path / "sg2_cli" / f"train_sg2_cli.log").read_text()
    assert "End of training." in log and "l_g:" in log


@pytest.mark.parametrize("model_type", ["StyleGAN2Model", "HiFaceGANModel"])
def test_face_runner_without_a_card_raises(model_type):
    """The face runners default to the card: built where there is none,
    one raises instead of running on the CPU."""
    from super_resolution_tpu_torch.utils.registry import MODEL_REGISTRY

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    if model_type == "StyleGAN2Model":
        opt = _sg_opt()
    else:
        opt = {"name": "hifacegan", "model_type": model_type, "scale": 1,
               "network_g": dict(HF_G), "path": {"pretrain_network_g": None}}
    with pytest.raises((RuntimeError, AssertionError)):
        build_model(opt)
    cls = MODEL_REGISTRY.get(model_type)
    assert cls.__init__.__defaults__ == ("cuda",)
