"""The video datasets and their helpers on the CPU against the JAX
package's: ``generate_frame_indices`` for the four paddings,
``read_img_seq``, ``duf_downsample``, the flow half of ``augment``, and
every registered video dataset's items for a seed on synthetic clip trees
in REDS's and Vimeo-90K's layouts, from disk and from LMDB (REDS's
precomputed flows too).

Tolerance: the items are equal to JAX's (the same frames, crops, flips and
order for a seed); ``duf_downsample``'s filter sums in another order than
XLA's convolution: 1e-6.
"""

import os
import random

import cv2
import numpy as np
import pytest

from super_resolution_tpu.data import transforms as jtr
from super_resolution_tpu.data import video_datasets as jvd
from super_resolution_tpu_torch.data import build_dataset
from super_resolution_tpu_torch.data import transforms as ttr
from super_resolution_tpu_torch.data import video_datasets as tvd
from super_resolution_tpu_torch.utils.flow_util import quantize_flow
from super_resolution_tpu_torch.utils.lmdb_util import make_lmdb_from_imgs
from torch_threads import few_torch_threads  # noqa: F401

REDS_CLIPS = ("000", "001", "002")     # 000 is in REDS4's validation split
FRAMES = 100                            # REDS's clips have 100 frames
SCALE = 4


def _img(rng, h, w):
    return (rng.random((h, w, 3)) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """REDS (GT 32 x 40, LQ 8 x 10, flows of the frames of clip 001 for a
    3-frame window), Vimeo-90K septuplets (GT 32 x 32, LQ 8 x 8), their
    meta files and LMDBs."""
    rng = np.random.default_rng(5)
    root = tmp_path_factory.mktemp("video")
    paths = {}
    for side, (h, w) in (("gt", (32, 40)), ("lq", (8, 10))):
        for clip in REDS_CLIPS:
            d = root / "reds" / side / clip
            d.mkdir(parents=True)
            for f in range(FRAMES):
                cv2.imwrite(str(d / f"{f:08d}.png"), _img(rng, h, w))
        paths[f"reds_{side}"] = str(root / "reds" / side)
    flow_dir = root / "reds" / "flow" / "001"
    flow_dir.mkdir(parents=True)
    for f in range(FRAMES):
        for tag in ("_p1", "_n1"):
            flow = (rng.standard_normal((8, 10, 2)) * 3).astype(np.float32)
            dx, dy = quantize_flow(flow, max_val=20, norm=False)
            cv2.imwrite(str(flow_dir / f"{f:08d}{tag}.png"),
                        np.concatenate([dx, dy], axis=0))
    paths["reds_flow"] = str(root / "reds" / "flow")
    meta = root / "reds_meta.txt"
    meta.write_text("".join(f"{c} {FRAMES} (32,40,3)\n" for c in REDS_CLIPS))
    paths["reds_meta"] = str(meta)
    flow_meta = root / "reds_flow_meta.txt"
    flow_meta.write_text(f"001 {FRAMES} (32,40,3)\n")
    paths["reds_flow_meta"] = str(flow_meta)
    for side in ("gt", "lq"):
        names = [f"{c}/{f:08d}.png" for c in REDS_CLIPS
                 for f in range(FRAMES)]
        out = str(root / f"reds_{side}.lmdb")
        make_lmdb_from_imgs(paths[f"reds_{side}"], out, names,
                            [n[:-4] for n in names])
        paths[f"reds_{side}_lmdb"] = out
    seqs = ["00001/0001", "00001/0002", "00002/0001"]
    for side, s in (("gt", 32), ("lq", 8)):
        for seq in seqs:
            d = root / "vimeo" / side / seq
            d.mkdir(parents=True)
            for i in range(1, 8):
                cv2.imwrite(str(d / f"im{i}.png"), _img(rng, s, s))
        paths[f"vimeo_{side}"] = str(root / "vimeo" / side)
    for side in ("gt", "lq"):
        names = [f"{q}/im{i}.png" for q in seqs for i in range(1, 8)]
        out = str(root / f"vimeo_{side}.lmdb")
        make_lmdb_from_imgs(paths[f"vimeo_{side}"], out, names,
                            [n[:-4] for n in names])
        paths[f"vimeo_{side}_lmdb"] = out
    vmeta = root / "vimeo_meta.txt"
    vmeta.write_text("".join(f"{s} (32,32,3)\n" for s in seqs))
    paths["vimeo_meta"] = str(vmeta)
    # a folder test set: two clips of 4 and 3 frames (GT 33 x 41 to show
    # the mod crop)
    for side, (h, w) in (("gt", (33, 41)), ("lq", (8, 10))):
        for clip, n in (("calendar", 4), ("city", 3)):
            d = root / "vid" / side / clip
            d.mkdir(parents=True)
            for f in range(n):
                cv2.imwrite(str(d / f"{f:08d}.png"), _img(rng, h, w))
        paths[f"vid_{side}"] = str(root / "vid" / side)
    return paths


def _assert_items_equal(a, b, close=()):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            if k in close:
                np.testing.assert_allclose(a[k], b[k], atol=1e-6, rtol=0,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def _both(opt, indices, seed=7, close=()):
    """The port's and JAX's dataset of ``opt``, each seeded with ``seed``;
    their items at ``indices`` compared (``close``: keys within 1e-6)."""
    tset = build_dataset(opt)
    jset = getattr(jvd, opt["type"])(dict(opt))
    assert len(tset) == len(jset)
    for ds in (tset, jset):
        if hasattr(ds, "seed"):
            ds.seed(seed)
    for i in indices:
        _assert_items_equal(tset[i], jset[i], close)
    return tset


@pytest.mark.parametrize("padding", ["replicate", "reflection",
                                     "reflection_circle", "circle"])
def test_generate_frame_indices_matches_jax(padding):
    for n in (5, 7):
        for crt in range(0, 12):
            assert (tvd.generate_frame_indices(crt, 12, n, padding)
                    == jvd.generate_frame_indices(crt, 12, n, padding))
    with pytest.raises(ValueError):
        tvd.generate_frame_indices(0, 12, 4)
    with pytest.raises(ValueError):
        tvd.generate_frame_indices(0, 12, 5, "wrap")


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_duf_downsample_matches_jax(scale, rng):
    x = rng.random((3, 36, 40, 3), dtype=np.float32)
    got = tvd.duf_downsample(x, 13, scale)
    ref = jvd.duf_downsample(x, 13, scale)
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tvd.generate_gaussian_kernel(13, 1.6),
                                  jvd.generate_gaussian_kernel(13, 1.6))


def test_read_img_seq_matches_jax(trees):
    folder = os.path.join(trees["vid_gt"], "calendar")
    for kw in ({}, dict(require_mod_crop=True, scale=SCALE)):
        got = tvd.read_img_seq(folder, **kw)
        np.testing.assert_array_equal(got, jvd.read_img_seq(folder, **kw))
    imgs, names = tvd.read_img_seq(folder, return_imgname=True)
    assert imgs.shape == (4, 33, 41, 3) and names[0] == "00000000"


def test_augment_flows_match_jax(rng):
    imgs = [rng.random((6, 8, 3), dtype=np.float32) for _ in range(2)]
    flows = [rng.standard_normal((6, 8, 2)).astype(np.float32)]
    for seed in range(8):
        got = ttr.augment(imgs, True, True, flows, return_status=True,
                          rng=random.Random(seed))
        ref = jtr.augment(imgs, True, True, flows, return_status=True,
                          rng=random.Random(seed))
        assert got[2] == ref[2]
        for g, r in zip(got[0] + got[1], ref[0] + ref[1]):
            np.testing.assert_array_equal(g, r)


def _reds(trees, backend, recurrent=False, **extra):
    opt = dict(type="REDSRecurrentDataset" if recurrent else "REDSDataset",
               dataroot_gt=trees["reds_gt"], dataroot_lq=trees["reds_lq"],
               meta_info_file=trees["reds_meta"], val_partition="REDS4",
               num_frame=5, gt_size=16, scale=SCALE, interval_list=[1, 2],
               random_reverse=True, use_hflip=True, use_rot=True,
               io_backend={"type": "disk"}, phase="train")
    if backend == "lmdb":
        opt.update(dataroot_gt=trees["reds_gt_lmdb"],
                   dataroot_lq=trees["reds_lq_lmdb"],
                   io_backend={"type": "lmdb",
                               "db_paths": [trees["reds_lq_lmdb"],
                                            trees["reds_gt_lmdb"]],
                               "client_keys": ["lq", "gt"]})
    opt.update(extra)
    return opt


@pytest.mark.parametrize("backend", ["disk", "lmdb"])
def test_reds_dataset_items_match_jax(trees, backend):
    tset = _both(_reds(trees, backend), [0, 57, 150, 199])
    assert len(tset) == 2 * FRAMES          # clip 000 is held out
    item = tset[3]
    assert item["lq"].shape == (5, 4, 4, 3) and item["gt"].shape == (16, 16,
                                                                        3)


def test_reds_dataset_flows_match_jax(trees):
    opt = _reds(trees, "disk", dataroot_flow=trees["reds_flow"],
                meta_info_file=trees["reds_flow_meta"], num_frame=3,
                interval_list=[1])
    tset = _both(opt, [0, 5, 99])
    assert tset[10]["flow"].shape == (3, 4, 4, 2)


@pytest.mark.parametrize("backend", ["disk", "lmdb"])
def test_reds_recurrent_dataset_items_match_jax(trees, backend):
    opt = _reds(trees, backend, recurrent=True, num_frame=15)
    tset = _both(opt, [0, 90, 120, 199])
    item = tset[1]
    assert item["lq"].shape == (15, 4, 4, 3)
    assert item["gt"].shape == (15, 16, 16, 3)
    test_split = _both(dict(opt, test_mode=True), [0, 99])
    assert len(test_split) == FRAMES


@pytest.mark.parametrize("backend", ["disk", "lmdb"])
@pytest.mark.parametrize("recurrent", [False, True])
def test_vimeo_datasets_match_jax(trees, recurrent, backend):
    opt = dict(type=("Vimeo90KRecurrentDataset" if recurrent
                     else "Vimeo90KDataset"),
               dataroot_gt=trees["vimeo_gt"], dataroot_lq=trees["vimeo_lq"],
               meta_info_file=trees["vimeo_meta"], num_frame=7, gt_size=16,
               scale=SCALE, random_reverse=True, use_hflip=True,
               use_rot=True, flip_sequence=recurrent,
               io_backend={"type": "disk"}, phase="train")
    if backend == "lmdb":
        opt.update(dataroot_gt=trees["vimeo_gt_lmdb"],
                   dataroot_lq=trees["vimeo_lq_lmdb"],
                   io_backend={"type": "lmdb",
                               "db_paths": [trees["vimeo_lq_lmdb"],
                                            trees["vimeo_gt_lmdb"]],
                               "client_keys": ["lq", "gt"]})
    tset = _both(opt, [0, 1, 2, 1])
    t = 14 if recurrent else 7
    assert tset[0]["lq"].shape == (t, 4, 4, 3)


@pytest.mark.parametrize("cache_data", [True, False])
def test_video_test_datasets_match_jax(trees, cache_data):
    base = dict(dataroot_gt=trees["vid_gt"], dataroot_lq=trees["vid_lq"],
                cache_data=cache_data, num_frame=5, padding="reflection",
                io_backend={"type": "disk"}, name="Vid", phase="test")
    tset = _both(dict(base, type="VideoTestDataset"), range(7))
    assert tset.data_info["border"] == [1, 1, 1, 1, 1, 1, 1]
    assert tset[5]["idx"] == "1/3" and tset[5]["folder"] == "city"
    for duf in (True, False):
        _both(dict(base, type="VideoTestDUFDataset", scale=SCALE,
                   use_duf_downsampling=duf), [0, 6],
              close=("lq",) if duf else ())
    if cache_data:
        rec = _both(dict(base, type="VideoRecurrentTestDataset"), [0, 1])
        assert rec[0]["lq"].shape == (4, 8, 10, 3)


def test_video_test_vimeo_dataset_matches_jax(trees):
    opt = dict(type="VideoTestVimeo90KDataset", dataroot_gt=trees["vimeo_gt"],
               dataroot_lq=trees["vimeo_lq"], meta_info_file=trees[
                   "vimeo_meta"], cache_data=False, num_frame=7,
               io_backend={"type": "disk"}, name="Vimeo", phase="test")
    tset = _both(opt, [0, 2])
    assert tset[1]["lq_path"].endswith("00001/0002/im4.png")
