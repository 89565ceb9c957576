"""The port's HATX and HybridHATNAF on the CPU against the JAX modules on the
same weights, carried across by the flax bridge: the ceil-padded overlap
windows, the spatial-gate FFN, the network with the ESC-infused OCAB, the
focus bias and top-k pruning each on and off, HybridHATNAF on the same
widths, and one SRModel train step of a tiny HATX against JAX's step on the
same batch and weights. Also: every ``network_g`` of the shipped option
files builds in the port, and HATX's drop path under per-RHAG remat.

Small config: embed 24 (2 heads of 12), 2 RHAGs x 2 HABXs, window 8,
overlap 0.5 (overlap window 12), ESC slabs of 8 channels with 5 x 5
filters, x2, on 16 x 24 inputs. Weights are drawn from the JAX param
tree's shapes (``jax.eval_shape``: a flax init costs seconds), every leaf
non-zero, the RPB tables wide, so each branch carries weight.

Tolerances: float32 on both sides, summation order only: a module 2e-5, a
network 3e-5, as for the ten archs. Top-k pruning is discrete: the inputs
are drawn until no kept key's score lies within 1e-6 of a pruned one's
(``_robust``), so that both packages keep the same keys.
"""

import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from super_resolution_tpu.models import hatx_arch as jhatx
from super_resolution_tpu.models import hybrid_hat_naf_arch as jnaf
from super_resolution_tpu_torch.convert.flax_bridge import flax_to_state_dict
from super_resolution_tpu_torch.models import build_network
from super_resolution_tpu_torch.models import hatx_arch as thatx
from super_resolution_tpu_torch.models import hybrid_hat_naf_arch as tnaf
from flax_weights import bridge
from torch_threads import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL_MODULE = 2e-5
ATOL_NET = 3e-5
SAFE_GAP = 1e-6
SMALL = dict(img_size=16, embed_dim=24, depths=(2, 2), num_heads=(2, 2),
             window_size=8, compress_ratio=3, squeeze_factor=6,
             conv_scale=0.05, overlap_ratio=0.5, mlp_ratio=2.0,
             hab_ffn_ratio=3.0, upscale=2, esc_pdim=8, esc_kernel=5,
             ocab_esc_pdim=8, ocab_esc_kernel=5, drop_path_rate=0.0)
# (ocab_esc_enable, use_focus_bias, kv_topk_ratio): every switch on and off,
# top-k on the focus score and on ||k||
CASES = {"plain": (False, False, 1.0), "focus": (False, True, 1.0),
         "esc_topk_norm": (True, False, 0.6),
         "esc_focus_topk": (True, True, 0.6)}


def _bridge(jmod, tmod, x, rng):
    return bridge(jmod, tmod, rng, x)


def _kept_gap(score, k_keep: int) -> float:
    """The smallest distance from the top-k threshold to a score that is not
    exactly on it; 0 where another score ties with the threshold's but for
    keys outside the image (score exactly 0 in both packages)."""
    thresh = torch.topk(score, k_keep, dim=-1).values[:, -1:]
    d = (score - thresh).abs()
    if int(((d == 0) & (thresh != 0)).sum()) > score.shape[0]:
        return 0.0
    return float(d[d > 0].min()) if bool((d > 0).any()) else np.inf


def _robust(draw, model, monkeypatch):
    """Inputs from ``draw()`` on which every OCABX's top-k threshold is at
    least SAFE_GAP from the next score."""
    gaps = []
    keep = thatx.topk_keep

    def recorded(score, k_keep):
        gaps.append(_kept_gap(score, k_keep))
        return keep(score, k_keep)
    with monkeypatch.context() as m:
        m.setattr(thatx, "topk_keep", recorded)
        for _ in range(20):
            x = draw()
            del gaps[:]
            with torch.no_grad():
                model(torch.from_numpy(x))
            if min(gaps, default=np.inf) > SAFE_GAP:
                return x
    raise AssertionError("no input with a safe top-k in 20 draws")


@pytest.mark.parametrize("ws,ratio", [(8, 0.5), (16, 0.6), (4, 0.5)])
def test_overlap_windows_ceil_matches_jax(ws, ratio, rng):
    ow = int(ws * ratio) + ws
    x = rng.standard_normal((2, 2 * ws, 3 * ws, 5)).astype(np.float32)
    ref = np.asarray(jhatx.extract_overlap_windows_ceil(jnp.asarray(x), ws,
                                                        ow))
    got = thatx.extract_overlap_windows_ceil(torch.from_numpy(x), ws, ow)
    assert got.shape == ref.shape == (12, ow * ow, 5)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_spatial_gate_ffn_matches_jax(act, rng):
    x = rng.standard_normal((2, 10, 12, 24)).astype(np.float32)
    jmod = jhatx.SpatialGateDConvFFN(24, 3.0, 3, act)
    tmod = thatx.SpatialGateDConvFFN(24, 3.0, 3, act)
    params = _bridge(jmod, tmod, x, rng)
    ref = np.asarray(jax.jit(jmod.apply)({"params": params},
                                         jnp.asarray(x)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL_MODULE, rtol=0)


def _hatx(case):
    esc, focus, ratio = CASES[case]
    return dict(SMALL, ocab_esc_enable=esc, use_focus_bias=focus,
                kv_topk_ratio=ratio)


@pytest.mark.parametrize("case", list(CASES))
def test_hatx_matches_jax(case, rng, monkeypatch):
    kw = _hatx(case)
    jnet, tnet = jhatx.HATX(**kw), thatx.HATX(**kw).eval()
    params = _bridge(jnet, tnet, np.zeros((1, 16, 16, 3), np.float32), rng)
    x = _robust(lambda: rng.random((2, 16, 24, 3), dtype=np.float32), tnet,
                monkeypatch)
    ref = np.asarray(jax.jit(jnet.apply)({"params": params},
                                         jnp.asarray(x)))
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 32, 48, 3)
    np.testing.assert_allclose(got, ref, atol=ATOL_NET, rtol=0)


def test_topk_keeps_the_k_largest_and_ties():
    """At ratio 0.6 of 144 keys the 86 largest scores are kept and every
    key tied at the threshold too; a pruned key's softmax weight is 0."""
    score = torch.linspace(-1, 1, 144)[None].repeat(2, 1)
    score[1, :10] = score[1, 58]
    keep = thatx.topk_keep(score, 86)
    assert keep.sum(-1).tolist() == [86, 96]
    assert bool(keep[0, 58:].all()) and not bool(keep[0, :58].any())
    blk = thatx.OCABX(8, 8, 0.5, 2, kv_topk_ratio=0.6)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 24, 24, 8)).astype(np.float32))
    probs, keeps = [], []
    softmax, keep = torch.softmax, thatx.topk_keep
    with pytest.MonkeyPatch.context() as m:
        m.setattr(thatx.torch, "softmax",
                  lambda a, dim: probs.append(softmax(a, dim)) or probs[-1])
        m.setattr(thatx, "topk_keep",
                  lambda s, k: keeps.append(keep(s, k)) or keeps[-1])
        with torch.no_grad():
            blk(x)
    # every query of a window weighs exactly its kept keys; the middle
    # window lies inside the image and keeps 86 of its 144
    weighed = (probs[0] > 0).sum(-1)
    assert (weighed == keeps[0].sum(-1)[:, None, None]).all()
    assert int(keeps[0][4].sum()) == 86


def test_hybrid_hat_naf_matches_jax(rng, monkeypatch):
    hat = {k: v for k, v in _hatx("esc_focus_topk").items()
           if k not in ("upscale", "window_size")}
    hat.update(depths=(1,), num_heads=(2,))
    kw = dict(naf_width=8, naf_blocks=2, window_size=8, upscale=2,
              hat_kwargs={k: list(v) if isinstance(v, tuple) else v
                          for k, v in hat.items()})
    jnet = jnaf.HybridHATNAF(**kw)
    tnet = tnaf.HybridHATNAF(**kw).eval()
    assert tnet.hat.window_size == 8 and tnet.hat.upscale == 2
    params = _bridge(jnet, tnet, np.zeros((1, 16, 16, 3), np.float32), rng)
    x = _robust(lambda: rng.random((1, 16, 16, 3), dtype=np.float32), tnet,
                monkeypatch)
    ref = np.asarray(jax.jit(jnet.apply)({"params": params},
                                         jnp.asarray(x)))
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL_NET, rtol=0)
    from super_resolution_tpu_torch.models.hat_arch import ESCConvAttn
    assert tnaf.ESCConvAttnWrapper is ESCConvAttn
    assert tnaf.simple_gate(torch.arange(4.0)).tolist() == [0.0, 3.0]


def test_hatx_upscale_other_than_2_3_4_raises():
    for s in (2, 3, 4):
        assert thatx.HATX(**dict(SMALL, depths=(1,), num_heads=(2,),
                                 upscale=s)).upscale == s
    with pytest.raises(ValueError, match="upscale 5"):
        thatx.HATX(**dict(SMALL, upscale=5))


def _network_options():
    """Each distinct network_g of options/{test,train,esc}, under the first
    file that names it."""
    import json

    import yaml

    nets = {}
    for sub in ("test", "train", "esc/test", "esc/train"):
        for path in sorted(glob.glob(os.path.join(REPO, "options", sub,
                                                  "*.yml"))):
            with open(path) as f:
                opt = yaml.safe_load(f)
            if isinstance(opt, dict) and "network_g" in opt:
                nets.setdefault(json.dumps(opt["network_g"], sort_keys=True),
                                pytest.param(opt["network_g"],
                                             id=os.path.relpath(path, REPO)))
    return list(nets.values())


@pytest.mark.parametrize("net", _network_options())
def test_every_shipped_network_builds(net):
    """Every network_g of options/{test,train,esc} builds in the port (the
    parameters on the meta device: shapes only). The HATX file's is
    among them."""
    with torch.device("meta"):
        model = build_network(net)
    assert sum(p.numel() for p in model.parameters()) > 0


def test_hatx_train_step_matches_jax(monkeypatch):
    """One step of the SRModel train step (L1, Adam, EMA) on a tiny HATX
    with the ESC OCAB, focus bias and top-k: the loss, then the parameters
    and the EMA, against JAX ``make_sr_train_step`` on the same batch and
    weights (rate-0 drop path: JAX draws its own)."""
    from super_resolution_tpu.runtime.train_loop import \
        build_optimizer as j_opt
    from super_resolution_tpu.runtime.train_loop import \
        init_train_state as j_init
    from super_resolution_tpu.runtime.train_loop import \
        make_sr_train_step as j_step
    from super_resolution_tpu_torch.runtime.train_loop import (
        init_train_state, make_sr_train_step)

    rng = np.random.default_rng(3)
    kw = dict(_hatx("esc_focus_topk"), depths=(1,), num_heads=(2,))
    jnet, tnet = jhatx.HATX(**kw), thatx.HATX(**kw)
    params = _bridge(jnet, tnet, np.zeros((1, 16, 16, 3), np.float32), rng)
    lq = _robust(lambda: rng.random((2, 16, 16, 3), dtype=np.float32),
                 tnet.eval(), monkeypatch)
    gt = rng.random((2, 32, 32, 3), dtype=np.float32)
    train_opt = {"optim_g": {"type": "Adam", "lr": 1e-3,
                             "betas": [0.9, 0.99]},
                 "scheduler": {"type": "MultiStepLR", "milestones": [3],
                               "gamma": 0.5},
                 "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0,
                               "reduction": "mean"},
                 "ema_decay": 0.9, "warmup_iter": -1}
    tx, _ = j_opt(train_opt)
    jstate = j_init(jax.tree_util.tree_map(jnp.asarray, params), tx, 0.9)
    jstate, logs = jax.jit(j_step(jnet, tx, train_opt))(
        jstate, {"lq": jnp.asarray(lq), "gt": jnp.asarray(gt)},
        jax.random.PRNGKey(0))
    state = init_train_state(tnet.train(), train_opt)
    got = make_sr_train_step(train_opt)(
        state, {"lq": torch.from_numpy(lq), "gt": torch.from_numpy(gt)},
        torch.Generator())
    np.testing.assert_allclose(float(got["l_pix"]), float(logs["l_pix"]),
                               rtol=1e-5)
    for mod, tree in ((tnet, jstate.params), (state.ema, jstate.ema_params)):
        ref = flax_to_state_dict(jax.device_get(tree), mod)
        now = mod.state_dict()
        diffs = torch.cat([(now[k] - ref[k]).abs().flatten() for k in ref
                           if ref[k].is_floating_point()])
        assert float(diffs.max()) <= 1e-4 and float(diffs.mean()) <= 1e-7


def test_drop_path_under_remat_gives_the_same_gradients():
    """Drop path at rate 0.5 in training mode: the gradients of a forward
    under per-RHAG remat equal those without it on the same generator seed;
    another seed gives others."""
    kw = dict(_hatx("esc_focus_topk"), depths=(2, 2), drop_path_rate=0.5)
    plain = thatx.HATX(**kw).train()
    remat = thatx.HATX(**dict(kw, use_checkpoint=True)).train()
    remat.load_state_dict(plain.state_dict())
    x = torch.from_numpy(np.random.default_rng(5).random(
        (2, 16, 16, 3), dtype=np.float32))

    def grads(net, seed):
        net.zero_grad()
        net(x, generator=torch.Generator().manual_seed(seed)).square().sum(
        ).backward()
        return {k: p.grad.clone() for k, p in net.named_parameters()}
    ref, got = grads(plain, 3), grads(remat, 3)
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], rtol=1e-6, atol=1e-6)
    other = grads(plain, 4)
    assert any(not torch.equal(other[k], ref[k]) for k in ref)


def test_hatx_training_file_trains_through_train_py(tmp_path):
    """The shipped HATX file through train.py's pipeline on the CPU: the
    file as it is but for its network (shrunk), its data roots (synthetic
    pairs named as DF2K-sub's, read through a meta_info_file that lists
    them, as the file's is) and its iteration counts: two steps, the tile
    validation (64 / 16) and a checkpoint."""
    import cv2

    from super_resolution_tpu_torch.runtime.checkpoint import STATE_FILE
    from super_resolution_tpu_torch.runtime.train_pipeline import \
        train_pipeline

    rng = np.random.default_rng(6)
    dirs = {k: tmp_path / k for k in ("gt", "lq", "val_gt", "val_lq")}
    for d in dirs.values():
        d.mkdir()
    names = [f"{i:04d}_s001.png" for i in range(3)]
    for name in names:
        gt = rng.integers(0, 256, (128, 128, 3)).astype(np.uint8)
        cv2.imwrite(str(dirs["gt"] / name), gt)
        cv2.imwrite(str(dirs["lq"] / name), cv2.resize(
            gt, (64, 64), interpolation=cv2.INTER_AREA))
    # a GT the meta file does not name, and so no pair
    cv2.imwrite(str(dirs["gt"] / "9999_s001.png"),
                np.zeros((8, 8, 3), np.uint8))
    meta = tmp_path / "meta_info.txt"
    meta.write_text("".join(f"{n} (128,128,3)\n" for n in names[:2]))
    gt = rng.integers(0, 256, (96, 96, 3)).astype(np.uint8)
    cv2.imwrite(str(dirs["val_gt"] / "bird.png"), gt)
    cv2.imwrite(str(dirs["val_lq"] / "bird.png"), cv2.resize(
        gt, (48, 48), interpolation=cv2.INTER_AREA))
    force = [
        f"datasets:train:dataroot_gt={dirs['gt']}",
        f"datasets:train:dataroot_lq={dirs['lq']}",
        f"datasets:train:meta_info_file={meta}",
        f"datasets:val:dataroot_gt={dirs['val_gt']}",
        f"datasets:val:dataroot_lq={dirs['val_lq']}",
        "network_g:embed_dim=24", "network_g:depths=[1, 1]",
        "network_g:num_heads=[2, 2]", "network_g:squeeze_factor=6",
        "network_g:esc_pdim=8", "network_g:esc_kernel=5",
        "network_g:ocab_esc_pdim=8", "network_g:ocab_esc_kernel=5",
        "train:total_iter=2", "val:val_freq=2", "val:save_img=false",
        "logger:save_checkpoint_freq=2", "logger:print_freq=1",
        "logger:use_tb_logger=false"]
    yml = os.path.join(REPO, "options/train/"
                       "train_HAT_SRx2_ESC_OCAB_from_scratch.yml")
    model, last = train_pipeline(str(tmp_path), argv=[
        "-opt", yml, "--device", "cpu", "--force_yml", *force])
    assert last == 2
    assert type(model.net_g).__name__ == "HATX"
    train_set = model.opt["datasets"]["train"]
    assert train_set["meta_info_file"] == str(meta)
    assert np.isfinite(model.get_current_log()["l_pix"])
    exp = os.path.join(model.opt["path"]["models"], "net_g_2")
    assert os.path.exists(os.path.join(exp, STATE_FILE))
