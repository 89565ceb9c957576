"""The GT-only datasets that make their LQ on the fly
(``ImageNetPairedDataset``, ``DownsampleImageDataset``) against the JAX
package's on the same PNGs and seeds: items in phase train (crop, flips,
ImageNet's upscale of an image smaller than ``gt_size``, DFLIP's crop at 0
where the image is no larger) and in phase val (the mod crop), the folder
and a ``meta_info_file``, and the train loader's batches over them. Both
packages run the same numpy arithmetic and the same ``random.Random``
draws: arrays equal."""

import os

import numpy as np
import pytest

from super_resolution_tpu_torch.data import build_dataloader, build_dataset

# (h, w): two larger than gt_size 24, one smaller on one side, one on both
SIZES = [(40, 50), (33, 29), (20, 36), (18, 22), (48, 48)]


@pytest.fixture(scope="module")
def gt_folder(tmp_path_factory):
    from super_resolution_tpu_torch.utils.img import imwrite

    root = tmp_path_factory.mktemp("gt_only")
    rng = np.random.default_rng(5)
    for i, (h, w) in enumerate(SIZES):
        img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        imwrite(img, str(root / "gt" / f"g{i}.png"))
    with open(root / "meta.txt", "w") as f:
        for i in (3, 0, 4):
            f.write(f"g{i}.png ({SIZES[i][0]},{SIZES[i][1]},3)\n")
    return str(root)


def _opt(kind, root, phase="train", meta=False, **kw):
    opt = {"name": kind, "type": kind, "phase": phase, "scale": 2,
           "dataroot_gt": os.path.join(root, "gt"),
           "io_backend": {"type": "disk"}, "gt_size": 24,
           "use_hflip": True, "use_rot": True, "batch_size_per_gpu": 2,
           "dataset_enlarge_ratio": 1}
    if meta:
        opt["meta_info_file"] = os.path.join(root, "meta.txt")
    opt.update(kw)
    return opt


def _assert_items(got, ref):
    assert got["gt_path"] == ref["gt_path"] == got["lq_path"]
    for key in ("lq", "gt"):
        assert got[key].dtype == ref[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], ref[key])


KINDS = ["ImageNetPairedDataset", "DownsampleImageDataset"]


@pytest.mark.parametrize("meta", [False, True], ids=["folder", "meta_info"])
@pytest.mark.parametrize("phase", ["train", "val"])
@pytest.mark.parametrize("kind", KINDS)
def test_items_match_jax(kind, phase, meta, gt_folder):
    from super_resolution_tpu.data import build_dataset as j_dataset

    opt = _opt(kind, gt_folder, phase, meta)
    got_set, ref_set = build_dataset(opt), j_dataset(opt)
    assert len(got_set) == len(ref_set) == (3 if meta else len(SIZES))
    # the first draws come from the dataset's seed-0 generator, the later
    # ones after a reseed, as the train loader makes them
    for seed in (None, 9):
        if seed is not None:
            got_set.seed(seed)
            ref_set.seed(seed)
        for i in list(range(len(got_set))) + [1, 1]:
            got, ref = got_set[i], ref_set[i]
            _assert_items(got, ref)
            h, w = got["gt"].shape[:2]
            assert got["lq"].shape == (-(-h // 2), -(-w // 2), 3)
            if phase == "val":
                assert h % 2 == 0 and w % 2 == 0


def test_imagenet_upscales_a_small_image(gt_folder):
    """g3 (18 x 22) is smaller than gt_size 24 on both sides: it is upscaled
    by the MATLAB bicubic until the crop exists."""
    from super_resolution_tpu.data import build_dataset as j_dataset

    opt = _opt("ImageNetPairedDataset", gt_folder, use_hflip=False,
               use_rot=False)
    got, ref = build_dataset(opt)[3], j_dataset(opt)[3]
    _assert_items(got, ref)
    assert got["gt"].shape == (24, 24, 3) and got["lq"].shape == (12, 12, 3)
    # DFLIP crops what there is at 0 instead
    dopt = dict(opt, type="DownsampleImageDataset")
    d_got, d_ref = build_dataset(dopt)[3], j_dataset(dopt)[3]
    _assert_items(d_got, d_ref)
    assert d_got["gt"].shape == (18, 22, 3)


@pytest.mark.parametrize("kind", KINDS)
def test_train_loader_batches_match_jax(kind, gt_folder):
    """Two epochs of batches over the three images of the meta file, all
    at least gt_size: the same order, crops and flips, arrays equal."""
    from super_resolution_tpu.data import build_dataloader as j_loader
    from super_resolution_tpu.data import build_dataset as j_dataset

    opt = _opt(kind, gt_folder, meta=True, dataset_enlarge_ratio=4,
               gt_size=16)
    got_loader = build_dataloader(build_dataset(opt), opt, seed=3)
    ref_loader = j_loader(j_dataset(opt), opt, seed=3)
    assert len(got_loader) == len(ref_loader) == 6
    for epoch in (0, 1):
        got = list(got_loader.epoch_iter(epoch))
        ref = list(ref_loader.epoch_iter(epoch))
        assert len(got) == len(ref) == 6
        for g, r in zip(got, ref):
            assert g["gt_path"] == r["gt_path"]
            for key in ("lq", "gt"):
                np.testing.assert_array_equal(g[key], r[key])
            assert g["gt"].shape == (2, 16, 16, 3)
            assert g["lq"].shape == (2, 8, 8, 3)
