"""The port's evaluation inputs against the JAX package: the paired and
single-image datasets on one folder (paths, order, arrays), the sequential
loader, the test half of the options (``--force_yml``, ``num_gpu: auto``,
the CLI flags) and the log banner. What the port does not read raises
``NotImplementedError``: another io_backend than the paired set's disk and
LMDB and the single set's disk, a train loader across devices. A paired
meta_info_file and the paired LMDB backend, once among them, are read as
JAX reads them.
No entry point picks the CPU by itself."""

import os
from os import path as osp

import cv2
import numpy as np
import pytest
import torch

from super_resolution_tpu.data import build_dataloader as j_build_loader
from super_resolution_tpu.data import build_dataset as j_build_dataset
from super_resolution_tpu_torch.data import build_dataloader, build_dataset

SIZES = [(40, 48), (48, 40), (36, 44)]


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """GT, LQ named '<stem>x2', LQ named '<stem>', and a meta_info file
    listing two LQ names in an order of its own."""
    root = tmp_path_factory.mktemp("sets")
    dirs = {k: root / k for k in ("gt", "lq_x2", "lq_same")}
    for d in dirs.values():
        d.mkdir()
    rng = np.random.default_rng(3)
    for i, (h, w) in enumerate(SIZES):
        gt = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        # the LQ named '<stem>' is one row short of GT / 2: the GT is then
        # cropped to LQ x scale, as the reference does
        lq = rng.integers(0, 256, (h // 2, w // 2, 3)).astype(np.uint8)
        cv2.imwrite(str(dirs["gt"] / f"im{i}.png"), gt)
        cv2.imwrite(str(dirs["lq_x2"] / f"im{i}x2.png"), lq)
        cv2.imwrite(str(dirs["lq_same"] / f"im{i}.png"), lq[:-1])
    meta = root / "meta.txt"
    meta.write_text("im2x2.png 1\nim0x2.png 1\n")
    return {k: str(v) for k, v in dirs.items()} | {"meta": str(meta)}


def _paired(folders, lq, **extra):
    return dict(name="Pairs", type="PairedImageDataset", phase="test",
                scale=2, dataroot_gt=folders["gt"], dataroot_lq=folders[lq],
                io_backend={"type": "disk"}, **extra)


def _assert_same_items(got_set, ref_set):
    assert len(got_set) == len(ref_set)
    got_loader = build_dataloader(got_set, got_set.opt)
    ref_loader = j_build_loader(ref_set, ref_set.opt)
    for got, ref in zip(got_loader, ref_loader, strict=True):
        assert got.keys() == ref.keys()
        for key in got:
            if isinstance(got[key], np.ndarray):
                assert got[key].dtype == ref[key].dtype == np.float32
                np.testing.assert_array_equal(got[key], ref[key])
            else:
                assert got[key] == ref[key]


NORM = dict(mean=[0.4488, 0.4371, 0.4040], std=[0.5, 0.6, 0.7])


@pytest.mark.parametrize("norm", [{}, NORM], ids=["plain", "mean_std"])
@pytest.mark.parametrize("lq,tmpl", [("lq_x2", "{}x2"), ("lq_x2", None),
                                     ("lq_same", None)])
def test_paired_dataset_matches_jax(folders, lq, tmpl, norm):
    extra = dict(norm) | ({"filename_tmpl": tmpl} if tmpl else {})
    opt = _paired(folders, lq, **extra)
    got, ref = build_dataset(opt), j_build_dataset(opt)
    assert got.paths == ref.paths
    _assert_same_items(got, ref)
    item = got[0]
    h, w = item["lq"].shape[:2]
    assert item["gt"].shape == (2 * h, 2 * w, 3)


@pytest.mark.parametrize("norm", [{}, NORM], ids=["plain", "mean_std"])
@pytest.mark.parametrize("meta", [False, True], ids=["folder", "meta_info"])
def test_single_dataset_matches_jax(folders, meta, norm):
    opt = dict(name="Singles", type="SingleImageDataset", phase="test",
               scale=2, dataroot_lq=folders["lq_x2"],
               io_backend={"type": "disk"}, **norm)
    if meta:
        opt["meta_info_file"] = folders["meta"]
    got, ref = build_dataset(opt), j_build_dataset(opt)
    assert got.paths == ref.paths
    assert len(got) == (2 if meta else 3)
    _assert_same_items(got, ref)


@pytest.mark.parametrize("case", ["lmdb", "single_lmdb", "meta_info",
                                  "train"])
def test_unported_inputs_raise(folders, case, tmp_path):
    """Each input the port does not read raises; the paired
    meta_info_file, ported since, is read as JAX reads it: the GT names it
    lists, in its order, each with the LQ ``filename_tmpl`` names. The
    paired LMDB backend is ported too: on roots that are no ``.lmdb``
    folders it raises JAX's ValueError. The train loader over a device
    mesh is ported: over a (data: 1) mesh of a gloo world of one it loads
    what it loads without one, as many batches as JAX's loader."""
    opt = _paired(folders, "lq_x2")
    if case == "lmdb":
        opt["io_backend"] = {"type": "lmdb"}
        for build in (build_dataset, j_build_dataset):
            with pytest.raises(ValueError, match="lmdb io_backend"):
                build(opt)
        return
    elif case == "single_lmdb":
        opt.update(type="SingleImageDataset", io_backend={"type": "lmdb"})
    elif case == "meta_info":
        meta = tmp_path / "meta_gt.txt"
        meta.write_text("im2.png (36,44,3)\nim0.png (40,48,3)\n")
        opt.update(meta_info_file=str(meta), filename_tmpl="{}x2")
        got, ref = build_dataset(opt), j_build_dataset(opt)
        assert got.paths == ref.paths
        assert [osp.basename(p["lq_path"]) for p in got.paths] == [
            "im2x2.png", "im0x2.png"]
        _assert_same_items(got, ref)
        return
    else:
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        opt.update(phase="train", gt_size=16, batch_size_per_gpu=2)
        plain = build_dataloader(build_dataset(opt), opt, seed=1)
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                                rank=0, world_size=1)
        try:
            mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
            meshed = build_dataloader(build_dataset(opt), opt, seed=1,
                                      mesh=mesh)
        finally:
            dist.destroy_process_group()
        assert len(meshed) == len(plain) == len(
            j_build_loader(j_build_dataset(opt), opt, seed=1))
        for a, b in zip(meshed.epoch_iter(0), plain.epoch_iter(0)):
            np.testing.assert_array_equal(a["gt"], b["gt"])
        return
    match = {"lmdb": "lmdb", "single_lmdb": "lmdb"}[case]
    with pytest.raises(NotImplementedError, match=match):
        build_dataset(opt)


FORCE = ["val:save_img=false", "network_g:embed_dim=60",
         "datasets:test_1:name=Set5b", "manual_seed=7",
         "network_g:depths=[2, 2]"]
# the keys the JAX package derives from its devices and processes
DEVICE_KEYS = ("dist", "rank", "world_size")


def test_parse_options_matches_jax(tmp_path):
    from super_resolution_tpu.utils.options import \
        parse_options as j_parse_options
    from super_resolution_tpu_torch.utils.options import parse_options

    argv = ["-opt", "options/test/HAT_SRx4.yml", "--force_yml", *FORCE]
    got, args = parse_options(str(tmp_path), is_train=False, argv=argv)
    ref, _ = j_parse_options(str(tmp_path), is_train=False, argv=argv)
    assert args.device == "cuda" and args.launcher == "none"
    for key in DEVICE_KEYS:
        got.pop(key), ref.pop(key)
    assert got == ref
    assert got["val"]["save_img"] is False
    assert got["network_g"]["depths"] == [2, 2]
    assert got["datasets"]["test_1"]["phase"] == "test"
    assert got["path"]["visualization"] == os.path.join(
        str(tmp_path), "results", "HAT_SRx4", "visualization")

    argv += ["--debug", "--auto_resume"]
    got, args = parse_options(str(tmp_path), is_train=False,
                              argv=argv + ["--device", "cpu"])
    ref, _ = j_parse_options(str(tmp_path), is_train=False, argv=argv)
    assert args.device == "cpu"
    assert got["name"] == ref["name"] == "debug_HAT_SRx4"
    assert got["auto_resume"] is ref["auto_resume"] is True


def test_force_yml_cannot_create_keys_and_launcher_is_none(tmp_path):
    from super_resolution_tpu_torch.utils.options import (dict2str,
                                                          parse_options,
                                                          yaml_load)
    from super_resolution_tpu.utils.options import dict2str as j_dict2str

    argv = ["-opt", "options/test/HAT_SRx4.yml"]
    with pytest.raises(KeyError, match="cannot create new key"):
        parse_options(str(tmp_path), argv=argv + ["--force_yml",
                                                  "inference_dtype=bf16"])
    with pytest.raises(SystemExit):
        parse_options(str(tmp_path), argv=argv + ["--launcher", "jax"])
    opt = yaml_load("options/test/HAT_SRx4.yml")
    assert dict2str(opt) == j_dict2str(opt)


def test_num_gpu_auto_chooses_no_device(tmp_path):
    """``num_gpu: auto`` records the count of cards. The device stays
    ``cuda``: with no card the runner and ``run_test`` raise, they do not
    run on the CPU."""
    from super_resolution_tpu_torch.runtime import build_model
    from super_resolution_tpu_torch.runtime.test_pipeline import run_test
    from super_resolution_tpu_torch.utils.options import process_options

    opt = dict(name="auto", model_type="ESRModel", scale=2, num_gpu="auto",
               manual_seed=0, network_g=dict(
                   type="ESC", dim=16, pdim=8, kernel_size=5, n_blocks=1,
                   conv_blocks=1, window_size=8, num_heads=2,
                   upscaling_factor=2), datasets={},
               path=dict(results_root=str(tmp_path)), val={})
    opt = process_options(opt, str(tmp_path))
    assert opt["num_gpu"] == torch.cuda.device_count()
    if torch.cuda.is_available():
        assert build_model(opt).device.type == "cuda"
        return
    with pytest.raises((RuntimeError, AssertionError)):
        build_model(opt)
    with pytest.raises((RuntimeError, AssertionError)):
        run_test(opt)


def test_env_info_and_logger(tmp_path):
    from super_resolution_tpu_torch.utils.logger import (get_env_info,
                                                         get_root_logger)

    info = get_env_info()
    assert f"torch {torch.__version__}" in info and "jax" not in info
    name = "super_resolution_tpu_torch.test_logger"
    log_file = tmp_path / "x.log"
    logger = get_root_logger(name, log_file=str(log_file))
    assert get_root_logger(name) is logger
    assert len(logger.handlers) == 2       # one stream, one file
    logger.info("hello")
    for h in logger.handlers:
        h.flush()
    assert "INFO: hello" in log_file.read_text()
    # a later run's log file takes the file handler over
    other = tmp_path / "y.log"
    assert get_root_logger(name, log_file=str(other)) is logger
    logger.info("again")
    for h in logger.handlers:
        h.flush()
    assert len(logger.handlers) == 2
    assert "again" in other.read_text()
    assert "again" not in log_file.read_text()


def test_exp_dirs_archive_an_existing_results_root(tmp_path):
    from super_resolution_tpu_torch.utils.misc import (make_exp_dirs,
                                                       scandir)
    from super_resolution_tpu.utils.misc import scandir as j_scandir

    res = tmp_path / "res"
    opt = {"rank": 0, "path": {"results_root": str(res), "log": str(res),
                               "visualization": str(res / "visualization"),
                               "pretrain_network_g": "x.pth"}}
    make_exp_dirs(opt)
    (res / "old.txt").write_text("x")
    make_exp_dirs(opt)
    assert sorted(os.listdir(res)) == ["visualization"]
    archived = [d for d in os.listdir(tmp_path) if "_archived_" in d]
    assert len(archived) == 1
    for kw in ({}, {"recursive": True}, {"recursive": True,
                                         "full_path": True},
               {"suffix": ".txt", "recursive": True}):
        assert (sorted(scandir(str(tmp_path), **kw))
                == sorted(j_scandir(str(tmp_path), **kw)))
