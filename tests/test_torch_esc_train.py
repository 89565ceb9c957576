"""The training parts the ESC family and the fork's HAT x2 add, on the CPU:
the gradients of the plain versions of rows 1, 9, 10 and 17 (the backward
of ``fused_msa_block_ad``, ``fused_ocab_attention_ad``,
``fused_attention_ad`` and ``msa_flash_attention_ad``) against
``jax.grad`` of the JAX ``*_ad`` functions (their forwards in Pallas
interpret mode), the autograd Function the card's entries go through with
the plain version standing in for each kernel, and every shipped training
file of the slice (the twelve ``ESRModel`` files under
``options/esc/train``, ``train_HAT_SRx2_from_scratch.yml`` and one
ImageNet file) building its dataset on synthetic images, its runner on a
narrowed network, and one CPU step.

Tolerances: float32 gradients of small blocks, summation order only
(``ATOL_GRAD`` as ``tests/test_torch_train_parts.py``, rtol 1e-4)."""

import glob
import os

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from super_resolution_tpu_torch.ops import cuda_attention as tca
from super_resolution_tpu_torch.ops import cuda_build
from super_resolution_tpu_torch.ops import cuda_window_attention as tcw
from super_resolution_tpu_torch.ops.attention import attention_with_bias
from torch_threads import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL_GRAD = 2e-5


def _row_inputs(rng):
    """Operands of rows 1, 9, 10 and 17 at a small size: C 16 in 2 heads,
    window 8 (overlap window 12), (2, 16, 16) images, 4 cut windows."""
    def t(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    c, heads, ws, ow, n = 16, 2, 8, 12, 64
    scale = (c // heads) ** -0.5
    return {
        "fused_msa_block": (
            (t(2, 16, 16, c), t(c, 3 * c, s=c ** -0.5), t(3 * c, s=0.1),
             t(c, c, s=c ** -0.5), t(c, s=0.1), t(heads, n, n, s=0.5)),
            dict(heads=heads, window_size=ws, scale=scale)),
        "fused_ocab_attention": (
            (t(2, 16, 16, c), t(2, 16, 16, 2 * c), t(heads, n, ow * ow,
                                                      s=0.5)),
            dict(heads=heads, window_size=ws, overlap_win=ow, scale=scale)),
        "fused_attention": (
            (t(4, heads, n, c // heads), t(4, heads, n, c // heads),
             t(4, heads, n, c // heads), t(heads, n, n, s=0.5)),
            dict(scale=scale)),
        "msa_flash_attention": (
            (t(2, 16, 16, 3 * c, s=0.5), t(heads, n, n, s=0.5)),
            dict(heads=heads, window_size=ws, scale=scale)),
    }


PORT_AD = {"fused_msa_block": tca.fused_msa_block_ad,
           "fused_ocab_attention": tca.fused_ocab_attention_ad,
           "fused_attention": tcw.fused_attention_ad,
           "msa_flash_attention": tcw.msa_flash_attention_ad}
PORT_PLAIN = {"fused_msa_block": lambda *a, **k: tca.msa_block_reference(
                  *a, None, **k),
              "fused_ocab_attention": tca.ocab_attention_reference,
              "fused_attention": attention_with_bias,
              "msa_flash_attention": tcw.msa_qtile_reference}


def _jax_ad(name, kw):
    from super_resolution_tpu.ops import pallas_attention as jpa

    if name == "fused_msa_block":
        n = kw["window_size"] ** 2
        zeros = jnp.zeros((1, n, n), jnp.float32)
        return lambda *a: jpa.fused_msa_block_ad(
            *a, zeros, kw["heads"], kw["window_size"], kw["scale"])
    if name == "fused_ocab_attention":
        return lambda *a: jpa.fused_ocab_attention_ad(
            *a, kw["heads"], kw["window_size"], kw["overlap_win"],
            kw["scale"])
    if name == "fused_attention":
        return lambda *a: jpa.fused_attention_ad(*a, kw["scale"])
    return lambda *a: jpa.msa_flash_attention_ad(
        *a, kw["heads"], kw["window_size"], kw["scale"])


@pytest.mark.parametrize("name", list(PORT_AD))
def test_row_gradient_matches_jax_ad(name, rng):
    """Every input's gradient of the port's ``*_ad`` entry (on the CPU: the
    plain version under autograd) against ``jax.grad`` of the JAX ``*_ad``
    function, for a random cotangent; the forwards agree too."""
    args, kw = _row_inputs(rng)[name]
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    out = PORT_AD[name](*targs, **kw)
    ct = rng.standard_normal(tuple(out.shape)).astype(np.float32)
    got = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), targs)

    fn = _jax_ad(name, kw)
    ref_out = fn(*map(jnp.asarray, args))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               atol=ATOL_GRAD, rtol=1e-4)
    ref = jax.grad(lambda *a: jnp.sum(fn(*a) * jnp.asarray(ct)),
                   argnums=tuple(range(len(args))))(*map(jnp.asarray, args))
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL_GRAD,
                                   rtol=1e-4, err_msg=f"{name} input {i}")


@pytest.mark.parametrize("name", list(PORT_AD))
def test_plain_backward_function_routes_every_gradient(name, rng):
    """The autograd Function of the card's entries, the plain version
    standing in for the kernel: every input's gradient equals autograd
    through the plain version, also where only the first and last inputs
    ask for one."""
    args, kw = _row_inputs(rng)[name]
    plain = lambda *a: PORT_PLAIN[name](*a, **kw)  # noqa: E731
    for need in (None, {0, len(args) - 1}):
        def leaves():
            return [torch.from_numpy(a).requires_grad_(need is None
                                                       or i in need)
                    for i, a in enumerate(args)]
        a1, a2 = leaves(), leaves()
        o1 = cuda_build._PlainBackward.apply(plain, plain, *a1)
        o2 = plain(*a2)
        torch.testing.assert_close(o1, o2, rtol=0, atol=0)
        ct = torch.from_numpy(
            rng.standard_normal(tuple(o2.shape)).astype(np.float32))
        w1 = [a for a in a1 if a.requires_grad]
        w2 = [a for a in a2 if a.requires_grad]
        for g1, g2 in zip(torch.autograd.grad(o1, w1, ct),
                          torch.autograd.grad(o2, w2, ct)):
            torch.testing.assert_close(g1, g2, rtol=1e-6, atol=1e-6)


def test_esc_routes_train_through_their_entries(monkeypatch):
    """``WindowAttentionESC`` at windows 8 (``fused_msa_block``), 32
    (``fused_attention``) and 48 (``msa_flash_attention``) calls the
    ``*_ad`` entry of its route, and every parameter gets a gradient."""
    from super_resolution_tpu_torch.models import esc_arch as tesc

    calls = []
    for name in ("fused_msa_block_ad", "fused_attention_ad",
                 "msa_flash_attention_ad"):
        fn = getattr(tesc, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)
        monkeypatch.setattr(tesc, name, counted)
    gen = torch.Generator().manual_seed(0)
    for ws in (8, 32, 48):
        attn = tesc.WindowAttentionESC(16, ws, 1)
        with torch.no_grad():
            for p in attn.parameters():
                p.normal_(generator=gen)
        x = torch.randn(1, 40, 44, 16, generator=gen)
        attn(x).square().sum().backward()
        assert all(p.grad is not None and p.grad.abs().sum() > 0
                   for p in attn.parameters())
    assert calls == ["fused_msa_block_ad", "fused_attention_ad",
                     "msa_flash_attention_ad"]


# the twelve ESRModel files, the fork's HAT x2 and one ImageNet file
FILES = (sorted(f for f in glob.glob(os.path.join(
    REPO, "options/esc/train/ESC_*.yml")) if "Real" not in f)
         + [os.path.join(REPO, "options/train/" + f) for f in (
             "train_HAT_SRx2_from_scratch.yml",
             "train_HAT_SRx2_ImageNet_from_scratch.yml")])
NARROW_ESC = dict(dim=16, pdim=8, kernel_size=5, n_blocks=1, conv_blocks=1,
                  num_heads=2, exp_ratio=1.0)
NARROW_HAT = dict(embed_dim=24, depths=[1, 1], num_heads=[2, 2],
                  window_size=8, squeeze_factor=6, mlp_ratio=2.0)


def _synthetic_data(root, ds, scale):
    """Two GT PNGs a little larger than the file's gt_size, their LR by
    INTER_AREA where the file's dataset reads LQ, a meta_info_file where it
    names one."""
    rng = np.random.default_rng(0)
    side = ds["gt_size"] + 4 * scale
    os.makedirs(os.path.join(root, "gt"))
    os.makedirs(os.path.join(root, "lq"))
    with open(os.path.join(root, "meta.txt"), "w") as meta:
        for i in range(2):
            gt = (rng.random((side, side, 3)) * 255).astype(np.uint8)
            cv2.imwrite(os.path.join(root, "gt", f"s{i}.png"), gt)
            lq = cv2.resize(gt, (side // scale, side // scale),
                            interpolation=cv2.INTER_AREA)
            cv2.imwrite(os.path.join(root, "lq", f"s{i}.png"), lq)
            meta.write(f"s{i}.png ({side},{side},3)\n")
    ds["dataroot_gt"] = os.path.join(root, "gt")
    if "dataroot_lq" in ds:
        ds["dataroot_lq"] = os.path.join(root, "lq")
    if ds.get("meta_info_file"):
        ds["meta_info_file"] = os.path.join(root, "meta.txt")


@pytest.mark.parametrize("yml", FILES, ids=lambda p: os.path.basename(p)[:-4])
def test_training_file_builds_and_steps(yml, tmp_path):
    """The file's dataset on synthetic images (batch cut to 2), its runner
    on a narrowed network (its type, scale, window and ESC switches kept),
    and one step on the CPU: a finite loss, most weights moved, an EMA
    kept, the schedule's first learning rate above 0."""
    from super_resolution_tpu_torch.data import (build_dataloader,
                                                 build_dataset)
    from super_resolution_tpu_torch.runtime import build_model
    from super_resolution_tpu_torch.utils.options import (process_options,
                                                          yaml_load)

    opt = yaml_load(yml)
    opt["datasets"] = {"train": opt["datasets"]["train"]}
    ds = opt["datasets"]["train"]
    ds["batch_size_per_gpu"] = 2
    _synthetic_data(str(tmp_path / "data"), ds, opt["scale"])
    net = opt["network_g"]
    if net["type"] == "HAT":
        net.update(NARROW_HAT)
        for key in ("esc_pdim", "ocab_esc_pdim"):
            net[key] = 8
        for key in ("esc_kernel", "ocab_esc_kernel"):
            net[key] = 5
    else:
        net.update(NARROW_ESC)
    opt["path"].update(pretrain_network_g=None,
                       experiments_root=str(tmp_path / "exp"))
    opt = process_options(opt, str(tmp_path), is_train=True)
    loader = build_dataloader(build_dataset(opt["datasets"]["train"]),
                              opt["datasets"]["train"], seed=0)
    batches = loader.epoch_iter(0)
    batch = next(batches)
    batches.close()
    assert batch["gt"].shape[1:3] == (ds["gt_size"],) * 2
    assert batch["lq"].shape[1] * opt["scale"] == ds["gt_size"]

    model = build_model(opt, "cpu")
    model.setup_training()
    before = {k: v.clone() for k, v in model.net_g.state_dict().items()}
    model.optimize_parameters(batch, 1)
    log = model.get_current_log()
    assert np.isfinite(log["l_pix"])
    assert type(model).__name__ == opt["model_type"]
    assert model.state.step == 1 and model.state.ema is not None
    moved = [k for k, v in model.net_g.state_dict().items()
             if not torch.equal(v, before[k])]
    assert len(moved) > len(before) // 2
    assert model.current_lrs(1)[0] > 0
