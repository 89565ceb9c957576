"""The paired GAN runners on the CPU: ``RealESRGANPairedDataset``'s items
against the JAX package's, and the first iteration of ``SRGANModel`` and
``ESRGANModel`` (MSRResNet and RRDBNet against the VGG-style
discriminator, the pixel, VGG perceptual and vanilla GAN losses of
BasicSR's SRGAN / ESRGAN files) against JAX's runners on bridged G, D and
VGG weights; then both names through ``train.py``'s pipeline on pairs a
``meta_info`` names.

Two faults of the JAX package are worked round here, on its side only, and
recorded in ROADMAP.md queue 3: its ``RealESRGANPairedDataset`` built from
a ``meta_info`` never sets the ``_file_client`` its ``__getitem__`` reads
(set to None here, the disk backend), and its GAN step passes
``update_sn_stats`` to the discriminator, which its
``VGGStyleDiscriminator`` does not take (an adapter drops it here; the
port's discriminator takes the flag and ignores it).

Small config: G at 8 features (MSRResNet 2 blocks; RRDBNet 1 block, grow
4), x4; D at 4 features on its 128 x 128 input (GT patches of 128, LQ 32);
VGG19 cut after conv2_2, its weights a seeded random state dict under
torchvision's names in a temporary .pth both packages load.

Tolerances: the dataset's arrays are equal (the same decode, crop and
flips). The first iteration's G and D losses to 1e-5 relative: float32,
summation order only; D's mean logits, which lie near 0 at D's init, to
1e-7 absolute.
"""

import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from super_resolution_tpu_torch.convert.flax_bridge import flax_to_state_dict
from super_resolution_tpu_torch.data import build_dataset
from super_resolution_tpu_torch.models.vgg_arch import \
    seeded_vgg19_state_dict
from super_resolution_tpu_torch.runtime import build_model
from super_resolution_tpu_torch.runtime.realgan import RealHATGANModel
from torch_threads import few_torch_threads  # noqa: F401

GT, SCALE, BATCH, SEED, LR = 128, 4, 2, 3, 1e-3
RTOL_LOSS = 1e-5
ATOL_LOGIT = 1e-7
NETS = {"SRGANModel": dict(type="MSRResNet", num_in_ch=3, num_out_ch=3,
                           num_feat=8, num_block=2, upscale=4),
        "ESRGANModel": dict(type="RRDBNet", num_in_ch=3, num_out_ch=3,
                            num_feat=8, num_block=1, num_grow_ch=4)}
DISC = dict(type="VGGStyleDiscriminator", num_in_ch=3, num_feat=4,
            input_size=GT)


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """Four GT images of 136 x 144 to 160 x 168 in a subfolder and their x4
    LR (box filter) in another, a ``meta_info`` listing them as 'gt_rel,
    lq_rel' (one blank line), and an unlisted GT file that proves the list
    is read. Returns the root."""
    from super_resolution_tpu_torch.utils.img import imwrite

    root = tmp_path_factory.mktemp("paired_gan")
    rng = np.random.default_rng(5)
    os.makedirs(root / "gt" / "sub")
    os.makedirs(root / "lq" / "sub")
    lines = []
    for i in range(4):
        h, w = 136 + 8 * i, 144 + 8 * i
        gt = rng.random((h, w, 3))
        gt = 0.25 * (gt + np.roll(gt, 1, 0) + np.roll(gt, 1, 1)
                     + np.roll(gt, (1, 1), (0, 1)))
        lq = gt.reshape(h // 4, 4, w // 4, 4, 3).mean(axis=(1, 3))
        imwrite((gt * 255).round().astype(np.uint8),
                str(root / "gt" / "sub" / f"p{i}.png"))
        imwrite((lq * 255).round().astype(np.uint8),
                str(root / "lq" / "sub" / f"p{i}x4.png"))
        lines.append(f"sub/p{i}.png, sub/p{i}x4.png")
    imwrite(np.zeros((64, 64, 3), np.uint8), str(root / "gt" / "extra.png"))
    with open(root / "meta_info.txt", "w") as f:
        f.write("\n".join(lines[:2] + [""] + lines[2:]) + "\n")
    return str(root)


@pytest.fixture(scope="module")
def vgg_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("vgg") / "vgg19.pth"
    torch.save(seeded_vgg19_state_dict(0), path)
    return str(path)


def _dataset_opt(pairs, phase):
    opt = {"name": "pairs", "type": "RealESRGANPairedDataset",
           "dataroot_gt": os.path.join(pairs, "gt"),
           "dataroot_lq": os.path.join(pairs, "lq"),
           "meta_info": os.path.join(pairs, "meta_info.txt"),
           "io_backend": {"type": "disk"}, "scale": SCALE, "phase": phase}
    if phase == "train":
        opt.update(gt_size=GT, use_hflip=True, use_rot=True)
    return opt


@pytest.mark.parametrize("phase", ["train", "val"])
def test_dataset_items_match_jax(pairs, phase):
    """The pairs the list names, in its order; each item's arrays and paths
    equal JAX's (train: the same seeded crops and flips)."""
    from super_resolution_tpu.data.paired_dataset import \
        RealESRGANPairedDataset as JDataset

    opt = _dataset_opt(pairs, phase)
    ds = build_dataset(opt)
    jds = JDataset(dict(opt))
    jds._file_client = None
    assert type(ds).__name__ == "RealESRGANPairedDataset"
    assert [p["gt_path"] for p in ds.paths] == [
        os.path.join(pairs, "gt", "sub", f"p{i}.png") for i in range(4)]
    assert ds.paths == jds.paths
    for seed in (0, 1):
        ds.seed(seed)
        jds.seed(seed)
        for i in range(len(ds)):
            got, ref = ds[i], jds[i]
            assert sorted(got) == sorted(ref)
            for k, v in ref.items():
                if isinstance(v, str):
                    assert got[k] == v
                else:
                    np.testing.assert_array_equal(got[k], v, err_msg=k)
            if phase == "train":
                assert got["gt"].shape == (GT, GT, 3)


def test_without_meta_info_it_is_the_paired_dataset(pairs):
    opt = dict(_dataset_opt(pairs, "val"), meta_info=None,
               dataroot_gt=os.path.join(pairs, "gt", "sub"),
               dataroot_lq=os.path.join(pairs, "lq", "sub"),
               filename_tmpl="{}x4")
    ds = build_dataset(opt)
    assert len(ds) == 4
    assert ds.paths[0]["lq_path"].endswith("p0x4.png")


def _options(model_type, vgg, **extra):
    opt = {
        "name": "paired_gan", "model_type": model_type, "scale": SCALE,
        "num_gpu": 1, "manual_seed": SEED, "is_train": True,
        "network_g": dict(NETS[model_type]), "network_d": dict(DISC),
        "datasets": {"train": {"gt_size": GT}},
        "path": {"pretrain_network_g": None},
        "train": {
            "ema_decay": 0.9,
            "optim_g": {"type": "Adam", "lr": LR, "betas": [0.9, 0.99]},
            "optim_d": {"type": "Adam", "lr": LR, "betas": [0.9, 0.99]},
            "scheduler": {"type": "MultiStepLR", "milestones": [2],
                          "gamma": 0.5},
            "total_iter": 4, "warmup_iter": -1,
            "pixel_opt": {"type": "L1Loss", "loss_weight": 1e-2,
                          "reduction": "mean"},
            "perceptual_opt": {
                "type": "PerceptualLoss", "vgg_weights_path": vgg,
                "layer_weights": {"conv2_2": 1}, "vgg_type": "vgg19",
                "use_input_norm": True, "perceptual_weight": 1.0,
                "style_weight": 0, "range_norm": False, "criterion": "l1"},
            "gan_opt": {"type": "GANLoss", "gan_type": "vanilla",
                        "real_label_val": 1.0, "fake_label_val": 0.0,
                        "loss_weight": 5e-3},
            "net_d_iters": 1, "net_d_init_iters": 0}}
    opt.update(extra)
    return opt


class _NoSNFlag:
    """JAX's VGGStyleDiscriminator under JAX's GAN step, which passes
    ``update_sn_stats`` and reads a ``batch_stats`` collection back: the
    call without the flag, and an empty collection."""

    def __init__(self, net):
        self.net = net

    def apply(self, variables, x, update_sn_stats=False, mutable=()):
        out = self.net.apply({"params": variables["params"]}, x)
        return (out, {"batch_stats": {}}) if mutable else out


def _g_weights(net, rng):
    """Random G weights (the port's seeded init, every all-zero tensor
    drawn small) as a state dict and as JAX's param tree."""
    from super_resolution_tpu.convert.torch_import import convert_state_dict
    from super_resolution_tpu.models import build_network as j_build
    from super_resolution_tpu_torch.models import build_network
    from super_resolution_tpu_torch.models.arch_util import init_weights

    tnet = build_network(net)
    init_weights(tnet, torch.Generator().manual_seed(0))
    sd = {k: (v if v.any() else torch.from_numpy(
        (rng.standard_normal(tuple(v.shape)) * 0.05).astype(np.float32)))
        for k, v in tnet.state_dict().items()}
    shapes = jax.eval_shape(lambda: j_build(net).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)))["params"])
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    return sd, convert_state_dict({k: v.numpy() for k, v in sd.items()},
                                  template, strict=True)


def _batch(rng):
    gt = rng.random((BATCH, GT, GT, 3)).astype(np.float32)
    gt = 0.25 * (gt + np.roll(gt, 1, 1) + np.roll(gt, 1, 2)
                 + np.roll(gt, (1, 1), (1, 2)))
    lq = gt.reshape(BATCH, GT // 4, 4, GT // 4, 4, 3).mean(axis=(2, 4))
    return {"lq": lq, "gt": gt}


@pytest.mark.parametrize("model_type", list(NETS))
def test_first_iteration_matches_jax(model_type, vgg_path, rng,
                                     monkeypatch):
    """The name resolves to RealHATGANModel without the synthesizer in
    both packages; the first iteration's G losses (pixel, perceptual, GAN,
    total) and D's (real, fake, the mean logits) agree, and D moved."""
    from super_resolution_tpu.runtime import build_model as j_build_model
    from super_resolution_tpu.runtime import sr_model as j_sr_model

    opt = _options(model_type, vgg_path)
    sd, params = _g_weights(NETS[model_type], rng)
    monkeypatch.setattr(j_sr_model.SRModel, "_init_params",
                        lambda self: None)
    jmodel = j_build_model(dict(opt))
    jmodel.params = jax.tree_util.tree_map(jnp.asarray, params)
    jmodel.net_d = _NoSNFlag(jmodel.net_d)
    jmodel.setup_training()
    model = build_model(opt, "cpu")
    assert isinstance(model, RealHATGANModel)
    assert type(jmodel).__name__ == "RealHATGANModel"
    model.net_g.load_state_dict(sd, strict=True)
    model.net_d.load_state_dict(flax_to_state_dict(
        jax.device_get(jmodel.params_d), model.net_d), strict=True)
    model.setup_training()
    assert not model.high_order and not hasattr(model, "synth")
    d_before = {k: v.clone() for k, v in model.net_d.state_dict().items()}

    batch = _batch(rng)
    jmodel.optimize_parameters(batch, 1)
    model.optimize_parameters(batch, 1)
    ref, got = jmodel.get_current_log(), model.get_current_log()
    assert sorted(got) == sorted(ref) == sorted(
        ["l_g_pix", "l_g_percep", "l_g_gan", "l_g_total", "l_d_real",
         "l_d_fake", "out_d_real", "out_d_fake"])
    for key in ref:
        # the mean logits lie near 0, where a relative bound means nothing
        np.testing.assert_allclose(
            got[key], ref[key], rtol=RTOL_LOSS,
            atol=ATOL_LOGIT if key.startswith("out_d") else 0, err_msg=key)
    assert not torch.equal(model.net_d.linear2.weight,
                           d_before["linear2.weight"])
    assert torch.equal(model.net_d.bn1_0.running_var,
                       d_before["bn1_0.running_var"])


@pytest.mark.parametrize("model_type", list(NETS))
def test_train_py_runs_on_a_meta_info(model_type, pairs, vgg_path,
                                      tmp_path):
    """``train.py``'s pipeline on the paired set a ``meta_info`` names: two
    iterations at batch 2, finite G and D losses, a checkpoint with D."""
    from super_resolution_tpu_torch.runtime.train_pipeline import \
        train_pipeline

    opt = _options(model_type, vgg_path)
    opt["datasets"] = {"train": dict(
        _dataset_opt(pairs, "train"), batch_size_per_gpu=BATCH,
        dataset_enlarge_ratio=1, num_worker_per_gpu=0)}
    opt["datasets"]["train"].pop("phase")
    opt["train"]["total_iter"] = 2
    opt["logger"] = {"print_freq": 1, "save_checkpoint_freq": 2,
                     "use_tb_logger": False}
    opt["path"].update(strict_load_g=True, resume_state=None,
                       experiments_root=str(tmp_path / "exp"))
    yml = tmp_path / "paired_gan.yml"
    with open(yml, "w") as f:
        yaml.safe_dump(opt, f)
    model, last = train_pipeline(str(tmp_path), argv=[
        "-opt", str(yml), "--device", "cpu"])
    assert last == 2 and isinstance(model, RealHATGANModel)
    logs = model.get_current_log()
    assert all(np.isfinite(logs[k]) for k in ("l_g_total", "l_d_real",
                                               "l_d_fake"))
    models = model.opt["path"]["models"]
    assert sorted(os.listdir(models)) == ["net_g_2"]
