"""The port's training pipeline (``train.py`` -> ``runtime/train_pipeline``
-> ``SRModel``'s training half) on the CPU: ``train_from_yaml`` against the
JAX ``run_train`` on the same synthetic pairs and weights (the loss of every
iteration, the validation PSNR), a run saved and resumed in the middle of an
epoch against the uninterrupted run (drop path on), the checkpoint's
weights loaded strict as a ``.pth``, a ``HATModel`` option file that builds
and steps, and the CLI in a subprocess that imports no JAX.

Tolerances: float32 on both sides; losses to 1e-5 relative, PSNR of the
EMA network's outputs (rounded to uint8 by both) to 1e-3 dB. The resumed
run repeats the uninterrupted one's operations exactly: equal."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import jax

from super_resolution_tpu_torch.runtime import sr_model as t_sr_model
from super_resolution_tpu_torch.runtime.checkpoint import STATE_FILE
from super_resolution_tpu_torch.runtime.train_pipeline import train_from_yaml
from torch_threads import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_NET = dict(type="HAT", img_size=16, embed_dim=24, depths=[1, 1],
                num_heads=[2, 2], window_size=8, compress_ratio=3,
                squeeze_factor=6, conv_scale=0.01, overlap_ratio=0.5,
                mlp_ratio=2.0, upscale=2, upsampler="pixelshuffle",
                drop_path_rate=0.0)


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """Four GT 48 x 48 PNGs with smooth content, their x2 LR by the port's
    MATLAB bicubic."""
    from super_resolution_tpu_torch.utils.img import imwrite
    from super_resolution_tpu_torch.utils.matlab import imresize

    root = tmp_path_factory.mktemp("train_pairs")
    rng = np.random.default_rng(11)
    for d in ("gt", "lq"):
        os.makedirs(root / d)
    for i in range(4):
        gt = rng.random((48, 48, 3))
        gt = 0.25 * (gt + np.roll(gt, 1, 0) + np.roll(gt, 1, 1)
                     + np.roll(gt, (1, 1), (0, 1)))
        gt = (gt * 255).round().astype(np.uint8)
        lq = imresize(gt.astype(np.float32) / 255.0, 0.5)
        imwrite(gt, str(root / "gt" / f"t{i}.png"))
        imwrite((np.clip(lq, 0, 1) * 255).round().astype(np.uint8),
                str(root / "lq" / f"t{i}.png"))
    return str(root)


def _options(pairs, root, net=TINY_NET, total_iter=4, batch=2, val=True,
             pretrain=None):
    data = {"type": "PairedImageDataset",
            "dataroot_gt": os.path.join(pairs, "gt"),
            "dataroot_lq": os.path.join(pairs, "lq"),
            "io_backend": {"type": "disk"}}
    opt = {
        "name": "tiny_train", "model_type": "SRModel", "scale": 2,
        "num_gpu": 1, "manual_seed": 5, "network_g": dict(net),
        "datasets": {"train": dict(data, name="synth", gt_size=32,
                                   use_hflip=True, use_rot=True,
                                   batch_size_per_gpu=batch,
                                   dataset_enlarge_ratio=1)},
        "train": {"optim_g": {"type": "Adam", "lr": 1e-3,
                              "betas": [0.9, 0.99], "weight_decay": 0},
                  "scheduler": {"type": "MultiStepLR", "milestones": [3],
                                "gamma": 0.5},
                  "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0,
                                "reduction": "mean"},
                  "ema_decay": 0.9, "total_iter": total_iter,
                  "warmup_iter": -1},
        "logger": {"print_freq": 1, "save_checkpoint_freq": 2,
                   "use_tb_logger": False},
        "path": {"pretrain_network_g": pretrain, "strict_load_g": True,
                 "resume_state": None, "experiments_root": str(root)},
    }
    if val:
        opt["datasets"]["val"] = dict(data, name="synthval")
        opt["val"] = {"val_freq": 2, "save_img": False,
                      "metrics": {"psnr": {"type": "calculate_psnr",
                                           "crop_border": 2,
                                           "test_y_channel": True}}}
    return opt


def _write(opt, path):
    with open(path, "w") as f:
        yaml.safe_dump(opt, f)
    return str(path)


def _seeded_pth(path, net=TINY_NET):
    """The runner's seeded weights with every all-zero tensor made random."""
    from super_resolution_tpu_torch.models import build_network
    from super_resolution_tpu_torch.models.arch_util import init_weights

    model = build_network(net)
    init_weights(model, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    sd = {k: (v if v.any() or not v.is_floating_point() else
              torch.from_numpy((rng.standard_normal(tuple(v.shape)) * 0.05)
                               .astype(np.float32)))
          for k, v in model.state_dict().items()}
    torch.save({"params": sd}, path)
    return str(path)


def _record(monkeypatch, mod, out):
    """Log each iteration's loss and each validation's PSNR of a runner
    class."""
    step, val = mod.SRModel.optimize_parameters, mod.SRModel.validation

    def rec_step(self, *a, **k):
        step(self, *a, **k)
        out["loss"].append(self.get_current_log()["l_pix"])

    def rec_val(self, *a, **k):
        val(self, *a, **k)
        out["psnr"].append(self.metric_results["psnr"])

    monkeypatch.setattr(mod.SRModel, "optimize_parameters", rec_step)
    monkeypatch.setattr(mod.SRModel, "validation", rec_val)


def test_train_from_yaml_matches_jax_run_train(pairs, tmp_path,
                                               monkeypatch):
    """4 iterations, validation and checkpoints at 2 and 4, on the same
    weights (a .pth both load strict) and the same loader order."""
    from super_resolution_tpu.runtime import sr_model as j_sr_model
    from super_resolution_tpu.runtime.train_pipeline import \
        run_train as j_run_train
    from super_resolution_tpu.models import build_network as j_build
    from super_resolution_tpu.utils.options import \
        process_options as j_process

    pth = _seeded_pth(tmp_path / "w.pth")
    # the JAX runner's own init is overwritten by the strict load; a tree
    # of zeros of its shapes stands in for it (a flax init costs seconds)
    def zeros(self):
        shapes = jax.eval_shape(lambda: j_build(self.opt["network_g"]).init(
            jax.random.PRNGKey(0), self._example_input())["params"])
        self.params = jax.tree_util.tree_map(
            lambda v: np.zeros(v.shape, np.float32), shapes)
    monkeypatch.setattr(j_sr_model.SRModel, "_init_params", zeros)
    # orbax's writes are not what is compared
    monkeypatch.setattr(j_sr_model.SRModel, "save", lambda *a: None)

    out = {p: {"loss": [], "psnr": []} for p in ("jax", "port")}
    _record(monkeypatch, j_sr_model, out["jax"])
    _record(monkeypatch, t_sr_model, out["port"])
    j_run_train(j_process(_options(pairs, tmp_path / "jax", pretrain=pth),
                          str(tmp_path), is_train=True))
    yml = _write(_options(pairs, tmp_path / "port", pretrain=pth),
                 tmp_path / "tiny.yml")
    model, last = train_from_yaml(yml, str(tmp_path), device="cpu")
    assert last == 4 and len(out["port"]["loss"]) == 4
    np.testing.assert_allclose(out["port"]["loss"], out["jax"]["loss"],
                               rtol=1e-5)
    assert len(out["port"]["psnr"]) == 2
    np.testing.assert_allclose(out["port"]["psnr"], out["jax"]["psnr"],
                               atol=1e-3)
    exp = tmp_path / "port" / "tiny_train"
    assert sorted(os.listdir(exp / "models")) == ["net_g_2", "net_g_4"]
    assert os.path.exists(exp / "tiny.yml")
    log = (exp / "train_tiny_train.log").read_text()
    assert "l_pix:" in log and "# psnr:" in log


def test_resume_mid_epoch_equals_an_uninterrupted_run(pairs, tmp_path):
    """Batch 1 (four iterations an epoch), drop path on: 3 iterations, then
    a run resumed from net_g_3 to 6, equals a run of 6: every loss, the
    weights, the EMA; the checkpoint's params load strict as a .pth."""
    net = dict(TINY_NET, drop_path_rate=0.3)
    losses = {}

    def run(name, total, resume=None):
        opt = _options(pairs, tmp_path / name, net=net, total_iter=total,
                       batch=1, val=False)
        opt["logger"]["save_checkpoint_freq"] = 3
        opt["path"]["resume_state"] = resume
        yml = _write(opt, tmp_path / f"{name}_{total}.yml")
        t_losses = []
        step = t_sr_model.SRModel.optimize_parameters

        def rec(self, *a, **k):
            step(self, *a, **k)
            t_losses.append(self.get_current_log()["l_pix"])
        t_sr_model.SRModel.optimize_parameters = rec
        try:
            model, last = train_from_yaml(yml, str(tmp_path), device="cpu")
        finally:
            t_sr_model.SRModel.optimize_parameters = step
        losses[name] = losses.get(name, []) + t_losses
        return model, last

    models = tmp_path / "parts" / "tiny_train" / "models"
    whole, last = run("whole", 6)
    run("parts", 3)
    parts, last_parts = run("parts", 6, resume=str(models / "net_g_3"))
    assert last == last_parts == 6
    assert losses["parts"] == losses["whole"]
    for a, b in ((whole.net_g, parts.net_g), (whole.state.ema,
                                              parts.state.ema)):
        for (k, v), w in zip(a.state_dict().items(),
                             b.state_dict().values()):
            assert torch.equal(v, w), k
    assert sorted(os.listdir(models)) == ["net_g_3", "net_g_6"]
    fresh = t_sr_model.SRModel(dict(whole.opt, path=dict(
        whole.opt["path"], pretrain_network_g=str(
            models / "net_g_6" / STATE_FILE))), device="cpu")
    for (k, v), w in zip(fresh.net_g.state_dict().items(),
                         whole.net_g.state_dict().values()):
        assert torch.equal(v, w), k
    fresh.load_network(str(models / "net_g_6"), param_key="params_ema")
    for (k, v), w in zip(fresh.net_g.state_dict().items(),
                         whole.state.ema.state_dict().values()):
        assert torch.equal(v, w), k


def test_hatmodel_option_file_builds_and_steps(tmp_path):
    """A shipped HATModel file (network shrunk, no pretrained weights)
    trains through SRModel's methods: one step, then a checkpoint."""
    from super_resolution_tpu_torch.runtime import build_model
    from super_resolution_tpu_torch.utils.options import (process_options,
                                                          yaml_load)

    yml = os.path.join(
        REPO, "options/train/train_HAT_SRx2_finetune_from_ImageNet_pretrain"
        ".yml")
    opt = yaml_load(yml)
    opt["network_g"] = dict(TINY_NET, drop_path_rate=0.1)
    opt["path"].update(pretrain_network_g=None,
                       experiments_root=str(tmp_path))
    opt = process_options(opt, str(tmp_path), is_train=True)
    model = build_model(opt, "cpu")
    assert type(model).__name__ == "HATModel"
    model.setup_training()
    rng = np.random.default_rng(0)
    before = {k: v.clone() for k, v in model.net_g.state_dict().items()}
    model.optimize_parameters({
        "lq": rng.random((2, 16, 16, 3), dtype=np.float32),
        "gt": rng.random((2, 32, 32, 3), dtype=np.float32)}, 1)
    assert np.isfinite(model.get_current_log()["l_pix"])
    assert model.current_lrs(1) == [pytest.approx(
        opt["train"]["optim_g"]["lr"], rel=1e-6)]
    assert any(not torch.equal(v, model.net_g.state_dict()[k])
               for k, v in before.items())
    assert not model.net_g.training
    model.save(0, 1)
    assert os.path.exists(os.path.join(opt["path"]["models"], "net_g_1",
                                       STATE_FILE))


TINY_ESC = dict(type="ESC", dim=16, pdim=8, kernel_size=5, n_blocks=1,
                conv_blocks=1, window_size=8, num_heads=2,
                upscaling_factor=2, exp_ratio=1.0)


def test_train_cli_runs_without_jax(pairs, tmp_path):
    """``python -m super_resolution_tpu_torch.train -opt <yml> --device cpu``
    trains, writes its experiment directory, and imports no JAX
    (``-X importtime`` lists every module it imported): an SRModel file,
    and an ESRModel file with the ESC strategy's options (top-level
    use_amp, gradient_clip, MESA from iteration 1, a momentum reset every
    iteration)."""
    esr = _options(pairs, tmp_path / "exp", net=TINY_ESC, total_iter=2)
    esr.update(name="tiny_esr", model_type="ESRModel", use_amp=True)
    esr["train"].update(gradient_clip=0.5, reset_momentum_iter=1, mesa_opt={
        "type": "L1Loss", "loss_weight": 0.5, "reduction": "mean",
        "start_ratio": 0.5})
    for opt in (_options(pairs, tmp_path / "exp", total_iter=2), esr):
        yml = _write(opt, tmp_path / f"{opt['name']}.yml")
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
        assert "super_resolution_tpu_torch.runtime.train_pipeline" in imported
        bad = [m for m in imported
               if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                      "super_resolution_tpu")]
        assert not bad, bad
        exp = tmp_path / "exp" / opt["name"]
        assert sorted(os.listdir(exp / "models")) == ["net_g_2"]
        log = (exp / f"train_{opt['name']}.log").read_text()
        assert "End of training." in log
    assert "Reset momentums for net_g at iteration 2" in log
    assert "l_mesa:" in log
