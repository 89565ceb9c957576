"""The video runners on the CPU against the JAX package's: the first two
updates of ``EDVRModel`` (DCNs at ``dcn_lr_mul``, only ``fusion`` training
for ``tsa_iter``) and of ``VideoRecurrentModel`` (SpyNet at
``flow_lr_mul``, frozen for ``fix_flow``), the parameters each rule
freezes or groups against the ones JAX's rules pick on the flax tree, the
first iteration of ``VideoGANModel`` and ``VideoRecurrentGANModel``
(U-Net discriminator with spectral norm, VGG19 perceptual loss, the frames
in the batch), the per-folder validation tables, and ``train.py`` on video
option files in a subprocess that imports no JAX.

Small config: EDVR at 16 features, deformable groups 2, one extract and one
reconstruct block, five 16 x 16 frames; BasicVSR at 8 features, one block,
two 64 x 64 frames (SpyNet's pyramid needs 64); the discriminator at 4
features; VGG19 cut after conv2_2, its weights a seeded random state dict.

Tolerances: float32, summation order only. Losses to 1e-5 relative (D's
mean logits, near 0, to 1e-6 absolute). Weights after the updates within
lr / 10 but for at most 0.5 % of the entries, each within 2 lr (Adam's
first update is lr times a gradient's sign, and an entry whose gradient is
within rounding of 0 moves +lr in one package and -lr in the other). The
validation tables (PSNR of 8-bit images) to 1e-3 dB: an output within
rounding of a level boundary can round to the other level.
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

from super_resolution_tpu_torch.convert.flax_bridge import (
    flax_to_state_dict, flax_torch_names, sn_stats_to_state_dict)
from super_resolution_tpu_torch.data import build_dataloader, build_dataset
from super_resolution_tpu_torch.models import build_network
from super_resolution_tpu_torch.models.vgg_arch import \
    seeded_vgg19_state_dict
from super_resolution_tpu_torch.runtime import build_model
from super_resolution_tpu_torch.runtime.train_loop import (lr_groups,
                                                           make_freeze_mask)
from flax_weights import random_params
from torch_threads import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3
RTOL_LOSS = 1e-5
ATOL_LOGIT = 1e-6
ATOL_PARAM = LR / 10
MAX_FLIP_SHARE = 0.005
ATOL_PSNR = 1e-3

EDVR = dict(type="EDVR", num_in_ch=3, num_out_ch=3, num_feat=16,
            num_frame=5, deformable_groups=2, num_extract_block=1,
            num_reconstruct_block=1, with_tsa=True)
BASICVSR = dict(type="BasicVSR", num_feat=8, num_block=1)
ICONVSR = dict(type="IconVSR", num_feat=8, num_block=1)
DISC = dict(type="UNetDiscriminatorSN", num_in_ch=3, num_feat=4,
            skip_connection=True)


def _img(rng, h, w):
    return (rng.random((h, w, 3)) * 255).astype(np.uint8)


def _clips(root, clips, frames, gt_hw, rng):
    """GT and LQ folders of ``clips`` x ``frames`` PNGs (LQ a quarter)."""
    for side, (h, w) in (("gt", gt_hw), ("lq", (gt_hw[0] // 4,
                                                gt_hw[1] // 4))):
        for clip in clips:
            d = root / side / clip
            d.mkdir(parents=True)
            for f in range(frames):
                cv2.imwrite(str(d / f"{f:08d}.png"), _img(rng, h, w))
    return str(root / "gt"), str(root / "lq")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    rng = np.random.default_rng(11)
    root = tmp_path_factory.mktemp("video_runs")
    out = {}
    out["reds_small"] = _clips(root / "reds_small", ["001"], 100, (64, 64),
                               rng)
    out["reds_large"] = _clips(root / "reds_large", ["001"], 100,
                               (256, 256), rng)
    out["val_small"] = _clips(root / "val_small", ["a", "b"], 3, (64, 64),
                              rng)
    out["val_large"] = _clips(root / "val_large", ["a", "b"], 2,
                              (256, 256), rng)
    meta = root / "meta.txt"
    meta.write_text("001 100 (64,64,3)\n")
    out["meta"] = str(meta)
    vgg = root / "vgg19.pth"
    torch.save(seeded_vgg19_state_dict(0), vgg)
    out["vgg"] = str(vgg)
    return out


def _options(model_type, net, **train):
    opt = {"name": "video", "model_type": model_type, "scale": 4,
           "num_gpu": 1, "manual_seed": 3, "is_train": True,
           "network_g": dict(net),
           "datasets": {"train": {"gt_size": 64}},
           "path": {"pretrain_network_g": None},
           "train": dict({
               "ema_decay": 0.9,
               "optim_g": {"type": "Adam", "lr": LR, "betas": [0.9, 0.99]},
               "scheduler": {"type": "MultiStepLR", "milestones": [8],
                             "gamma": 0.5},
               "total_iter": 4, "warmup_iter": -1,
               "pixel_opt": {"type": "CharbonnierLoss", "loss_weight": 1.0,
                             "reduction": "mean"}}, **train)}
    return opt


def _gan(opt, vgg):
    opt["network_d"] = dict(DISC)
    opt["train"].update(
        optim_d={"type": "Adam", "lr": LR, "betas": [0.9, 0.99]},
        perceptual_opt={"type": "PerceptualLoss", "vgg_weights_path": vgg,
                        "layer_weights": {"conv2_2": 1}, "vgg_type": "vgg19",
                        "use_input_norm": True, "perceptual_weight": 1.0,
                        "style_weight": 0, "range_norm": False,
                        "criterion": "l1"},
        gan_opt={"type": "GANLoss", "gan_type": "vanilla",
                 "real_label_val": 1.0, "fake_label_val": 0.0,
                 "loss_weight": 5e-3},
        net_d_iters=1, net_d_init_iters=0)
    return opt


def _g_params(net, x, rng):
    from super_resolution_tpu.models import build_network as j_build

    shapes = jax.eval_shape(lambda: j_build(net).init(
        jax.random.PRNGKey(0), jnp.asarray(x)))
    return random_params(shapes["params"], rng)


def _runners(opt, x, rng, monkeypatch, setup=True):
    """The JAX runner (its flax init replaced by random weights of the
    tree's shapes) and the port's on the same weights (D's too)."""
    from super_resolution_tpu.runtime import build_model as j_build_model
    from super_resolution_tpu.runtime import sr_model as j_sr_model

    params = _g_params(opt["network_g"], x, rng)
    monkeypatch.setattr(j_sr_model.SRModel, "_init_params",
                        lambda self: None)
    if "network_d" in opt:
        # D's flax init in one compiled call rather than op by op
        from super_resolution_tpu.models import discriminator_arch as jdisc

        cls = jdisc.UNetDiscriminatorSN
        flax_init = cls.init
        monkeypatch.setattr(cls, "init", lambda self, key, x: jax.jit(
            lambda k, xx: flax_init(self, k, xx))(key, x))
    jmodel = j_build_model(dict(opt))
    jmodel.params = jax.tree_util.tree_map(jnp.asarray, params)
    model = build_model(opt, "cpu")
    model.net_g.load_state_dict(flax_to_state_dict(params, model.net_g),
                                strict=True)
    if setup:
        jmodel.setup_training()
        model.setup_training()
        if "network_d" in opt:
            dsd = flax_to_state_dict(jax.device_get(jmodel.params_d),
                                     model.net_d)
            dsd.update(sn_stats_to_state_dict(
                jax.device_get(jmodel.sn_stats)))
            model.net_d.load_state_dict(dsd, strict=True)
    return jmodel, model, params


def _weights_close(model, jparams, params):
    ref = flax_to_state_dict(jax.device_get(jparams), model.net_g)
    own = model.net_g.state_dict()
    d = torch.cat([(own[k] - v).abs().flatten() for k, v in ref.items()
                   if v.is_floating_point()])
    assert float((d > ATOL_PARAM).float().mean()) <= MAX_FLIP_SHARE
    assert float(d.max()) <= 2 * LR


def _moved(model, params, names):
    """{torch name: whether it moved from the bridged ``params``}."""
    before = flax_to_state_dict(params, model.net_g)
    own = model.net_g.state_dict()
    return {k: not torch.equal(own[k], before[k]) for k in names}


def _batch(rng, lq_shape, gt_shape):
    return {"lq": rng.random(lq_shape, dtype=np.float32),
            "gt": rng.random(gt_shape, dtype=np.float32)}


@pytest.mark.parametrize("case", ["edvr", "basicvsr"])
def test_first_updates_match_jax(case, rng, monkeypatch):
    """Two updates: the first with the frozen part still (EDVR's all but
    ``fusion``, BasicVSR's SpyNet), the second with everything at its
    group's learning rate; both losses and the weights after them against
    JAX's runner."""
    if case == "edvr":
        opt = _options("EDVRModel", EDVR, tsa_iter=1, dcn_lr_mul=0.25)
        batches = [_batch(rng, (2, 5, 16, 16, 3), (2, 64, 64, 3))
                   for _ in range(2)]
        frozen = lambda k: "fusion" not in k          # noqa: E731
    else:
        opt = _options("VideoRecurrentModel", BASICVSR, fix_flow=1,
                       flow_lr_mul=0.5)
        batches = [_batch(rng, (1, 2, 64, 64, 3), (1, 2, 256, 256, 3))
                   for _ in range(2)]
        frozen = lambda k: "spynet" in k              # noqa: E731
    jmodel, model, params = _runners(opt, batches[0]["lq"][:1], rng,
                                     monkeypatch)
    names = [k for k, _ in model.net_g.named_parameters()]
    for it, batch in enumerate(batches, 1):
        jmodel.optimize_parameters(batch, it)
        model.optimize_parameters(batch, it)
        np.testing.assert_allclose(model.get_current_log()["l_pix"],
                                   float(jmodel.get_current_log()["l_pix"]),
                                   rtol=RTOL_LOSS)
        if it == 1:
            moved = _moved(model, params, names)
            assert not any(moved[k] for k in names if frozen(k))
            assert all(moved[k] for k in names if not frozen(k)
                       and "conv_offset" not in k)
        _weights_close(model, jmodel.state.params, params)
    moved = _moved(model, params, names)
    assert all(moved[k] for k in names if frozen(k))


def _jax_selected(params, needles):
    from super_resolution_tpu.runtime.train_loop import _path_contains

    return {path for path, _ in jax.tree_util.tree_flatten_with_path(
        params)[0] if _path_contains(path, needles)}


@pytest.mark.parametrize("net,needles", [
    (EDVR, ("dcn",)), (EDVR, ("fusion",)), (BASICVSR, ("spynet",)),
    (ICONVSR, ("spynet",)), (ICONVSR, ("spynet", "edvr"))])
def test_rules_pick_the_parameters_jax_picks(net, needles, rng):
    """The torch names a substring selects (the lr groups, the freeze
    mask's rules, its ``only`` form) are the flax paths JAX's
    ``_path_contains`` selects, through the bridge's name map."""
    from super_resolution_tpu.runtime.train_loop import \
        make_freeze_mask as j_freeze

    shape = (1, 5, 64, 64, 3) if net["type"] != "EDVR" else (1, 5, 16, 16,
                                                             3)
    params = _g_params(net, np.zeros(shape, np.float32), rng)
    tnet = build_network(net)
    names = flax_torch_names(params, tnet)
    want = {names[tuple(k.key for k in p)]
            for p in _jax_selected(params, needles)}
    assert want and len(want) < len(names)

    groups = lr_groups(tnet.named_parameters(), {needles[0]: 0.5})
    ids = {id(p) for p in groups[0]["params"]}
    got = {k for k, p in tnet.named_parameters() if id(p) in ids}
    if len(needles) == 1:
        assert groups[0]["lr_mult"] == 0.5 and got == want

    for rule, frozen_want in (((needles, 2), want),
                              (("only", needles, 2), set(names.values())
                               - want)):
        mask = make_freeze_mask([rule])
        for p in tnet.parameters():
            p.grad = torch.ones_like(p)
        mask(tnet.named_parameters(), 1)
        frozen = {k for k, p in tnet.named_parameters()
                  if not p.grad.any()}
        assert frozen == frozen_want
        jmask = j_freeze([rule])(jax.tree_util.tree_map(
            lambda v: jnp.ones(np.shape(v), jnp.float32), params),
            jnp.asarray(1))
        jfrozen = {names[tuple(k.key for k in p)] for p, v in
                   jax.tree_util.tree_flatten_with_path(jmask)[0]
                   if not np.asarray(v).any()}
        assert jfrozen == frozen
        mask(tnet.named_parameters(), 2)
        assert all(p.grad.any() for _, p in tnet.named_parameters()
                   if _ not in frozen) and frozen


@pytest.mark.parametrize("case", ["edvr", "basicvsr"])
def test_gan_first_iteration_matches_jax(case, trees, rng, monkeypatch):
    """One G and D iteration: every G and D loss against JAX's, D moved,
    G's weights after the update (EDVR's under ``grad_clip_norm``: the
    shared G step clips, as JAX's optimizer chain does), SpyNet still under
    ``fix_flow``."""
    if case == "edvr":
        # a clip of the global norm too, which JAX's optimizer chains
        opt = _gan(_options("VideoGANModel", EDVR, grad_clip_norm=0.05),
                   trees["vgg"])
        batch = _batch(rng, (1, 5, 16, 16, 3), (1, 64, 64, 3))
    else:
        opt = _gan(_options("VideoRecurrentGANModel", BASICVSR, fix_flow=2,
                            lr_flow=5e-4), trees["vgg"])
        opt["datasets"]["train"]["gt_size"] = 256
        batch = _batch(rng, (1, 2, 64, 64, 3), (1, 2, 256, 256, 3))
    jmodel, model, params = _runners(opt, batch["lq"], rng, monkeypatch)
    d_before = {k: v.clone() for k, v in model.net_d.state_dict().items()}
    jmodel.optimize_parameters(batch, 1)
    model.optimize_parameters(batch, 1)
    ref = {k: float(v) for k, v in jmodel.log_dict.items()}
    got = model.get_current_log()
    assert sorted(got) == sorted(ref) == sorted(
        ["l_g_pix", "l_g_percep", "l_g_gan", "l_g_total", "l_d_real",
         "l_d_fake", "out_d_real", "out_d_fake"])
    for key in ref:
        np.testing.assert_allclose(
            got[key], ref[key], rtol=RTOL_LOSS,
            atol=ATOL_LOGIT if key.startswith("out_d") else 0, err_msg=key)
    assert not torch.equal(model.net_d.conv0.weight, d_before["conv0.weight"])
    _weights_close(model, jmodel.state.params, params)
    if case == "basicvsr":
        names = [k for k, _ in model.net_g.named_parameters()]
        moved = _moved(model, params, names)
        assert not any(moved[k] for k in names if "spynet" in k)
        assert model.state.optimizer.param_groups[0]["lr_mult"] == 0.5


def _val_opt(model_type, net, dataset, roots, **val):
    gt, lq = roots
    opt = _options(model_type, net)
    opt.update(is_train=False, name="video_val",
               val=dict({"metrics": {"psnr": {"type": "calculate_psnr",
                                              "crop_border": 0}}}, **val))
    ds = {"name": "vid", "type": dataset, "dataroot_gt": gt,
          "dataroot_lq": lq, "cache_data": True, "num_frame": 5,
          "padding": "reflection", "io_backend": {"type": "disk"},
          "phase": "val"}
    return opt, ds


@pytest.mark.parametrize("case", ["edvr", "basicvsr", "center"])
def test_validation_tables_match_jax(case, trees, rng, monkeypatch):
    """The per-folder, per-frame PSNR tables and the folder means against
    JAX's runner on the same weights and clips."""
    if case == "edvr":
        opt, ds_opt = _val_opt("EDVRModel", EDVR, "VideoTestDataset",
                               trees["val_small"])
        x = np.zeros((1, 5, 16, 16, 3), np.float32)
    else:
        opt, ds_opt = _val_opt("VideoRecurrentModel", BASICVSR,
                               "VideoRecurrentTestDataset",
                               trees["val_large"])
        x = np.zeros((1, 2, 64, 64, 3), np.float32)
    jmodel, model, _ = _runners(opt, x, rng, monkeypatch, setup=False)
    from super_resolution_tpu.data import build_dataset as j_build_dataset

    class Loader:
        def __init__(self, dataset):
            self.dataset = dataset

    jmodel.nondist_validation(Loader(j_build_dataset(dict(ds_opt))), 7,
                              None, False)
    if case == "center":
        # JAX scores the centre output against the clip's frame 0 (queue
        # 3): the port's one row is JAX's whole-clip table's centre row
        model.center_frame_only = True
    model.validation(build_dataloader(build_dataset(ds_opt), ds_opt), 7)
    assert sorted(model.metric_results) == sorted(jmodel.metric_results)
    for folder, table in jmodel.metric_results.items():
        got = model.metric_results[folder]
        assert got.shape == table.shape and got.dtype == table.dtype
        if case == "center":
            t = table.shape[0]
            np.testing.assert_allclose(got[0], table[t // 2],
                                       atol=ATOL_PSNR, rtol=0)
            assert not got[1:].any()
            continue
        np.testing.assert_allclose(got, table, atol=ATOL_PSNR, rtol=0)
    if case == "center":
        return
    rec, jrec = (m.best_metric_results["vid"]["psnr"]
                 for m in (model, jmodel))
    assert rec["iter"] == jrec["iter"] == 7
    np.testing.assert_allclose(rec["val"], jrec["val"], atol=ATOL_PSNR)


def _train_file(kind, trees, root):
    gt, lq = trees["reds_small" if kind == "edvr" else "reds_large"]
    vgt, vlq = trees["val_small" if kind == "edvr" else "val_large"]
    net = EDVR if kind == "edvr" else BASICVSR
    model_type = "EDVRModel" if kind == "edvr" else "VideoRecurrentGANModel"
    opt = _options(model_type, net, total_iter=2,
                   **({"tsa_iter": 1, "dcn_lr_mul": 0.25} if kind == "edvr"
                      else {"fix_flow": 1, "lr_flow": 5e-4}))
    if kind != "edvr":
        opt = _gan(opt, trees["vgg"])
    train = {"name": "reds", "type": ("REDSDataset" if kind == "edvr"
                                      else "REDSRecurrentDataset"),
             "dataroot_gt": gt, "dataroot_lq": lq,
             "meta_info_file": trees["meta"], "val_partition": "REDS4",
             "io_backend": {"type": "disk"}, "num_frame": 5 if kind ==
             "edvr" else 2, "gt_size": 64 if kind == "edvr" else 256,
             "interval_list": [1], "random_reverse": False,
             "use_hflip": True, "use_rot": True, "batch_size_per_gpu": 1,
             "dataset_enlarge_ratio": 1}
    val = {"name": "vid", "type": ("VideoTestDataset" if kind == "edvr"
                                   else "VideoRecurrentTestDataset"),
           "dataroot_gt": vgt, "dataroot_lq": vlq, "cache_data": True,
           "num_frame": 5, "padding": "reflection",
           "io_backend": {"type": "disk"}}
    opt.update(name=f"video_{kind}", datasets={"train": train, "val": val},
               val={"val_freq": 2, "save_img": False,
                    "metrics": {"psnr": {"type": "calculate_psnr",
                                         "crop_border": 0}}},
               logger={"print_freq": 1, "save_checkpoint_freq": 2,
                       "use_tb_logger": False})
    opt["path"].update(strict_load_g=True, resume_state=None,
                       experiments_root=str(root / "exp"))
    yml = root / f"{kind}.yml"
    with open(yml, "w") as f:
        yaml.safe_dump(opt, f)
    return opt, str(yml)


def test_train_cli_video_files_run_without_jax(trees, tmp_path):
    """``python -m super_resolution_tpu_torch.train -opt <yml> --device
    cpu`` on EDVR (REDSDataset, ``tsa_iter``, ``dcn_lr_mul``) and on
    BasicVSR's GAN runner (REDSRecurrentDataset, ``fix_flow``,
    ``lr_flow``): two iterations, a validation with its folder table, a
    checkpoint, and no JAX among the modules it imported."""
    for kind in ("edvr", "basicvsr"):
        opt, yml = _train_file(kind, trees, tmp_path)
        r = subprocess.run([sys.executable, "-X", "importtime", "-m",
                            "super_resolution_tpu_torch.train", "-opt", yml,
                            "--device", "cpu"],
                           capture_output=True, text=True, timeout=300,
                           cwd=str(tmp_path),
                           env={"PYTHONPATH": REPO, "PATH": "",
                                "HOME": str(tmp_path)})
        assert r.returncode == 0, r.stderr[-3000:]
        imported = [line.rsplit("|", 1)[-1].strip()
                    for line in r.stderr.splitlines()
                    if line.startswith("import time:")]
        assert "super_resolution_tpu_torch.runtime.video_models" in imported
        bad = [m for m in imported
               if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                      "super_resolution_tpu")]
        assert not bad, bad
        exp = tmp_path / "exp" / opt["name"]
        assert sorted(os.listdir(exp / "models")) == ["net_g_2"]
        log = (exp / f"train_{opt['name']}.log").read_text()
        assert "End of training." in log
        assert "Validation vid" in log and "# a:" in log


def test_runner_defaults_to_the_card():
    """A video runner built without a device is on the card; where no card
    is visible (the CPU test run) building one raises: nothing falls back
    to the CPU."""
    opt = _options("VideoRecurrentModel", BASICVSR)
    if torch.cuda.is_available():
        assert build_model(opt).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            build_model(opt)


def test_gan_step_clips_the_global_norm(trees, rng):
    """``grad_clip_norm`` in a GAN runner: G's gradients reach the optimizer
    with their global norm at the bound (JAX chains
    ``clip_by_global_norm`` before the update of every runner's optimizer;
    the shared G step clips likewise, the real-world runners' too)."""
    from super_resolution_tpu_torch.runtime.train_loop import global_norm

    opt = _gan(_options("VideoGANModel", EDVR, grad_clip_norm=1e-3),
               trees["vgg"])
    model = build_model(opt, "cpu")
    model.setup_training()
    seen = []
    step = model.state.optimizer.step

    def record(*args, **kw):
        grads = [p.grad for g in model.state.optimizer.param_groups
                 for p in g["params"]]
        seen.append(float(global_norm(grads)))
        return step(*args, **kw)

    model.state.optimizer.step = record
    model.optimize_parameters(_batch(rng, (1, 5, 16, 16, 3),
                                     (1, 64, 64, 3)), 1)
    assert len(seen) == 1
    np.testing.assert_allclose(seen[0], 1e-3, rtol=1e-5)
