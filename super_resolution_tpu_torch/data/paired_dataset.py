"""Paired LQ/GT and single-LQ datasets (port of
super_resolution_tpu/data/paired_dataset.py; ref:
basicsr/data/paired_image_dataset.py:10-106,
single_image_dataset.py:10-40).

Datasets are plain indexable objects returning float32 RGB HWC [0, 1]
numpy arrays. In phase ``train`` a pair is cropped at random to
``gt_size`` and flipped and transposed (``use_hflip``, ``use_rot``), with
the draws from the dataset's own ``random.Random``, which the train loader
reseeds every epoch (:meth:`PairedImageDataset.seed`). The paired set reads
folders on disk, or with ``io_backend: {type: lmdb}`` two ``.lmdb``
folders (keys from their meta_info.txt, values decoded by
``utils/img.py::imfrombytes``). Another backend raises
``NotImplementedError`` rather than being read another way (the JAX
package reads its roots as folders on disk). A paired ``meta_info_file``
lists the GT names, each paired with the LQ of the same name through
``filename_tmpl``; :class:`RealESRGANPairedDataset`'s ``meta_info`` lists
both paths of a pair."""

from __future__ import annotations

import random
import re
from os import path as osp

import numpy as np

from super_resolution_tpu_torch.data.transforms import (augment,
                                                        paired_random_crop)
from super_resolution_tpu_torch.utils.img import (img2tensor, imfrombytes,
                                                  imread)
from super_resolution_tpu_torch.utils.misc import scandir
from super_resolution_tpu_torch.utils.registry import DATASET_REGISTRY


def paired_paths_from_folders(lq_folder: str, gt_folder: str,
                              filename_tmpl: str = "{}"):
    """Match LQ/GT files by stem (ref: data_util.py::paired_paths_from_folder).
    An LQ stem matches its GT stem as it is or with a trailing 'x<scale>'
    taken off; ``filename_tmpl`` is accepted, as in the JAX package, and the
    'x<scale>' rule covers the templates the option files name."""
    lq_names = sorted(scandir(lq_folder))
    gt_names = sorted(scandir(gt_folder))
    if len(lq_names) != len(gt_names):
        raise ValueError(f"Folders have mismatched sizes: {len(lq_names)} LQ "
                         f"vs {len(gt_names)} GT")
    paths = []
    gt_by_stem = {osp.splitext(osp.basename(p))[0]: p for p in gt_names}
    for lq_name in lq_names:
        stem = osp.splitext(osp.basename(lq_name))[0]
        gt_stem = stem
        if stem not in gt_by_stem:
            m = re.match(r"(.*?)x\d+$", stem)
            if m and m.group(1) in gt_by_stem:
                gt_stem = m.group(1)
        if gt_stem not in gt_by_stem:
            raise FileNotFoundError(f"No GT match for LQ {lq_name}")
        paths.append({"lq_path": osp.join(lq_folder, lq_name),
                      "gt_path": osp.join(gt_folder, gt_by_stem[gt_stem])})
    return paths


def paired_paths_from_meta_info(lq_folder: str, gt_folder: str,
                                meta_info_file: str, filename_tmpl: str = "{}"):
    """Pairs from a meta_info file listing GT names, the first word of a
    line, in its order; the LQ of GT '<stem><ext>' is
    ``filename_tmpl.format(stem) + ext`` (ref:
    data_util.py::paired_paths_from_meta_info_file)."""
    with open(meta_info_file, "r") as f:
        gt_names = [line.strip().split(" ")[0] for line in f if line.strip()]
    paths = []
    for gt_name in gt_names:
        stem, ext = osp.splitext(gt_name)
        paths.append({"lq_path": osp.join(lq_folder,
                                          f"{filename_tmpl.format(stem)}{ext}"),
                      "gt_path": osp.join(gt_folder, gt_name)})
    return paths


def paired_paths_from_lmdb(lq_folder: str, gt_folder: str):
    """Keys from the meta_info.txt the LMDB writer puts next to data.mdb,
    sorted (ref: data_util.py::paired_paths_from_lmdb;
    lmdb_util.py:78-87)."""
    if not (lq_folder.endswith(".lmdb") and gt_folder.endswith(".lmdb")):
        raise ValueError("lmdb io_backend requires both dataroots to be "
                         f".lmdb folders, got {lq_folder} / {gt_folder}")

    def read_keys(folder):
        with open(osp.join(folder, "meta_info.txt")) as f:
            return [line.split(".")[0] for line in f if line.strip()]

    lq_keys, gt_keys = read_keys(lq_folder), read_keys(gt_folder)
    if set(lq_keys) != set(gt_keys):
        raise ValueError("LQ and GT lmdbs hold different key sets")
    return [{"lq_path": k, "gt_path": k} for k in sorted(gt_keys)]


def _check_supported(opt: dict, readable=("disk",)) -> str:
    backend = (opt.get("io_backend") or {}).get("type", "disk")
    if backend not in readable:
        raise NotImplementedError(
            f"{opt.get('name')}: io_backend '{backend}': this dataset reads "
            f"{' or '.join(readable)} (the JAX package reads the roots of "
            f"another backend as folders on disk)")
    return backend


def _normalize(opt: dict, *imgs):
    if opt.get("mean") is None:
        return imgs
    mean = np.asarray(opt["mean"], dtype=np.float32)
    std = np.asarray(opt.get("std", [1, 1, 1]), dtype=np.float32)
    return tuple((img - mean) / std for img in imgs)


@DATASET_REGISTRY.register()
class PairedImageDataset:
    """LQ/GT pairs from two folders, or those a ``meta_info_file`` names
    (ref: paired_image_dataset.py:47-94). In phase ``train`` a random crop
    of ``gt_size`` and the flips, else the GT cropped to LQ x scale; then
    ``mean`` / ``std`` applied."""

    def __init__(self, opt: dict):
        backend = _check_supported(opt, ("disk", "lmdb"))
        self.opt = opt
        self.gt_folder = opt["dataroot_gt"]
        self.lq_folder = opt["dataroot_lq"]
        self.filename_tmpl = opt.get("filename_tmpl", "{}")
        self._file_client = None
        if backend == "lmdb":
            from super_resolution_tpu_torch.utils.file_client import \
                FileClient

            self.paths = paired_paths_from_lmdb(self.lq_folder,
                                                self.gt_folder)
            self._file_client = FileClient(
                "lmdb", db_paths=[self.lq_folder, self.gt_folder],
                client_keys=["lq", "gt"])
        else:
            self.paths = self._pair_paths(opt)
        self._rng = None

    def _pair_paths(self, opt: dict) -> list:
        if opt.get("meta_info_file"):
            return paired_paths_from_meta_info(
                self.lq_folder, self.gt_folder, opt["meta_info_file"],
                self.filename_tmpl)
        return paired_paths_from_folders(self.lq_folder, self.gt_folder,
                                         self.filename_tmpl)

    def _read(self, p: dict, key: str) -> np.ndarray:
        """The image of ``p[key + '_path']`` ('gt' or 'lq'), RGB float32."""
        if self._file_client is not None:
            content = self._file_client.get(p[f"{key}_path"], key)
            return img2tensor(imfrombytes(content, float32=True))
        return img2tensor(imread(p[f"{key}_path"], float32=True))

    def seed(self, seed: int) -> None:
        """Reseed the crops and flips (the train loader, every epoch)."""
        self._rng = random.Random(seed)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index: int) -> dict:
        scale = self.opt["scale"]
        p = self.paths[index]
        img_gt, img_lq = self._read(p, "gt"), self._read(p, "lq")
        if self.opt.get("phase") == "train":
            img_gt, img_lq = paired_random_crop(
                img_gt, img_lq, self.opt["gt_size"], scale, rng=self._rng)
            img_gt, img_lq = augment([img_gt, img_lq],
                                     self.opt.get("use_hflip", True),
                                     self.opt.get("use_rot", True),
                                     rng=self._rng)
        else:
            h, w = img_lq.shape[0], img_lq.shape[1]
            img_gt = img_gt[0:h * scale, 0:w * scale, :]
        img_gt, img_lq = _normalize(self.opt, img_gt, img_lq)
        return {"lq": img_lq, "gt": img_gt,
                "lq_path": p["lq_path"], "gt_path": p["gt_path"]}


def paired_paths_from_pair_list(lq_folder: str, gt_folder: str,
                                meta_info: str):
    """Pairs from a file whose lines are 'gt_rel, lq_rel' (ref:
    basicsr/data/realesrgan_paired_dataset.py:64-71); blank lines skipped."""
    paths = []
    with open(meta_info) as f:
        for line in f:
            if not line.strip():
                continue
            gt_rel, lq_rel = (p.strip() for p in line.split(","))
            paths.append({"gt_path": osp.join(gt_folder, gt_rel),
                          "lq_path": osp.join(lq_folder, lq_rel)})
    return paths


@DATASET_REGISTRY.register()
class RealESRGANPairedDataset(PairedImageDataset):
    """:class:`PairedImageDataset` whose pairs, where the options have a
    ``meta_info``, are the lines of that file, 'gt_rel, lq_rel' (ref:
    basicsr/data/realesrgan_paired_dataset.py:12-110); crops, flips and
    ``mean`` / ``std`` as the paired set's."""

    def _pair_paths(self, opt: dict) -> list:
        if opt.get("meta_info"):
            return paired_paths_from_pair_list(
                self.lq_folder, self.gt_folder, opt["meta_info"])
        return super()._pair_paths(opt)


@DATASET_REGISTRY.register()
class SingleImageDataset:
    """LQ-only dataset: every file of a folder, or the names a
    ``meta_info_file`` lists (ref: single_image_dataset.py:10-40)."""

    def __init__(self, opt: dict):
        _check_supported(opt)
        self.opt = opt
        self.lq_folder = opt["dataroot_lq"]
        if opt.get("meta_info_file"):
            with open(opt["meta_info_file"], "r") as f:
                self.paths = [osp.join(self.lq_folder,
                                       line.strip().split(" ")[0])
                              for line in f if line.strip()]
        else:
            self.paths = sorted(scandir(self.lq_folder, full_path=True))

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index: int) -> dict:
        lq_path = self.paths[index]
        img_lq, = _normalize(self.opt,
                             img2tensor(imread(lq_path, float32=True)))
        return {"lq": img_lq, "lq_path": lq_path}
