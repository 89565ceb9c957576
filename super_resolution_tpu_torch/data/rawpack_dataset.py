"""RawPack dataset: decode-free packed training data through the native
reader (port of super_resolution_tpu/data/rawpack_dataset.py).

Pack once with :func:`pack_folder` (PNG / JPG decoded to raw uint8 RGB HWC
records; ``tools/pack_dataset.py``), then train from mmap'd reads and the
C++ parallel crop sampler of ``csrc/rawpack.cpp`` (``native.py``). The
role the reference fills with LMDB (basicsr/utils/lmdb_util.py:9-199 and
the file client's lmdb backend), without a decode per item.
"""

from __future__ import annotations

import ctypes
import random
import struct
from os import path as osp

import numpy as np

from super_resolution_tpu_torch.utils.misc import scandir
from super_resolution_tpu_torch.utils.registry import DATASET_REGISTRY

_MAGIC = b"SRPK"
_VERSION = 1


def pack_folder(folder: str, out_path: str, suffix=(".png", ".jpg", ".jpeg",
                                                    ".bmp")) -> int:
    """Decode every image in `folder` (sorted) into a RawPack file.
    Returns the number of items packed."""
    from super_resolution_tpu_torch.utils.img import imread

    names = sorted(n for n in scandir(folder)
                   if n.lower().endswith(tuple(suffix)))
    metas = []
    offset = None
    with open(out_path, "wb") as f:
        header_size = 16 + 24 * len(names)
        f.write(_MAGIC)
        f.write(struct.pack("<I", _VERSION))
        f.write(struct.pack("<Q", len(names)))
        f.seek(header_size)
        offset = header_size
        for name in names:
            img = imread(osp.join(folder, name))  # BGR uint8 HWC
            img = np.ascontiguousarray(img[:, :, ::-1])  # store RGB
            h, w, c = img.shape
            metas.append((h, w, c, offset))
            f.write(img.tobytes())
            offset += h * w * c
        f.seek(16)
        for h, w, c, off in metas:
            f.write(struct.pack("<IIIIQ", h, w, c, 0, off))
    return len(names)


class RawPackReader:
    """ctypes wrapper over the native mmap reader."""

    def __init__(self, path: str):
        from super_resolution_tpu_torch.native import get_lib

        self._lib = get_lib()
        self._handle = self._lib.rawpack_open(path.encode())
        if not self._handle:
            raise IOError(f"Failed to open RawPack file: {path}")

    def __len__(self) -> int:
        return self._lib.rawpack_len(self._handle)

    def info(self, idx: int):
        h = ctypes.c_int64()
        w = ctypes.c_int64()
        c = ctypes.c_int64()
        if self._lib.rawpack_info(self._handle, idx, ctypes.byref(h),
                                  ctypes.byref(w), ctypes.byref(c)) != 0:
            raise IndexError(idx)
        return h.value, w.value, c.value

    def read(self, idx: int) -> np.ndarray:
        h, w, c = self.info(idx)
        out = np.empty((h, w, c), np.uint8)
        if self._lib.rawpack_read(self._handle, idx,
                                  out.ctypes.data_as(ctypes.c_void_p)) != 0:
            raise IndexError(idx)
        return out

    def crop_batch(self, idxs, tops, lefts, crop: int, hflips=None,
                   rots=None, n_threads: int = 4) -> np.ndarray:
        n = len(idxs)
        lengths = [len(a) for a in (tops, lefts, hflips, rots)
                   if a is not None]
        if n == 0 or crop < 1 or any(m != n for m in lengths):
            raise ValueError(f"crop_batch: {n} indices, crop {crop}, "
                             f"other lengths {lengths}")
        idxs = np.ascontiguousarray(idxs, np.int64)
        tops = np.ascontiguousarray(tops, np.int64)
        lefts = np.ascontiguousarray(lefts, np.int64)
        _, _, c = self.info(int(idxs[0]))
        out = np.empty((n, crop, crop, c), np.uint8)
        hf = (np.ascontiguousarray(hflips, np.uint8)
              if hflips is not None else None)
        rt = (np.ascontiguousarray(rots, np.uint8)
              if rots is not None else None)
        ret = self._lib.rawpack_crop_batch(
            self._handle, n,
            idxs.ctypes.data_as(ctypes.c_void_p),
            tops.ctypes.data_as(ctypes.c_void_p),
            lefts.ctypes.data_as(ctypes.c_void_p), crop,
            hf.ctypes.data_as(ctypes.c_void_p) if hf is not None else None,
            rt.ctypes.data_as(ctypes.c_void_p) if rt is not None else None,
            out.ctypes.data_as(ctypes.c_void_p), n_threads)
        if ret != 0:
            raise ValueError("rawpack_crop_batch failed (bad index/crop)")
        return out

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.rawpack_close(self._handle)
            self._handle = None


@DATASET_REGISTRY.register()
class RawPackPairedDataset:
    """Paired LQ/GT training dataset over two aligned RawPack files.

    opt: {gt_pack, lq_pack, scale, gt_size, use_hflip, use_rot}.
    Items are index-aligned (pack both folders with pack_folder on the
    same sorted listing).
    """

    def __init__(self, opt: dict):
        self.opt = opt
        self.gt = RawPackReader(opt["gt_pack"])
        self.lq = RawPackReader(opt["lq_pack"])
        if len(self.gt) != len(self.lq):
            raise ValueError("gt/lq packs have different lengths")
        self._rng = random.Random(0)

    def seed(self, seed: int):
        self._rng = random.Random(seed)

    def __len__(self):
        return len(self.gt)

    def __getitem__(self, index: int) -> dict:
        scale = self.opt["scale"]
        gt_size = self.opt["gt_size"]
        lq_size = gt_size // scale
        h, w, _ = self.lq.info(index)
        top = self._rng.randint(0, h - lq_size)
        left = self._rng.randint(0, w - lq_size)
        hflip = self.opt.get("use_hflip", True) and self._rng.random() < 0.5
        rot = self.opt.get("use_rot", True) and self._rng.random() < 0.5

        lq = self.lq.crop_batch([index], [top], [left], lq_size,
                                [hflip], [rot])[0]
        gt = self.gt.crop_batch([index], [top * scale], [left * scale],
                                gt_size, [hflip], [rot])[0]
        return {"lq": lq.astype(np.float32) / 255.0,
                "gt": gt.astype(np.float32) / 255.0,
                "lq_path": f"rawpack://{index}",
                "gt_path": f"rawpack://{index}"}

    def sample_batch(self, batch_size: int) -> dict:
        """Fully-native batch sampling: one C++ call gathers all crops in
        parallel threads (bypasses per-item Python)."""
        scale = self.opt["scale"]
        gt_size = self.opt["gt_size"]
        lq_size = gt_size // scale
        idxs, tops, lefts, hflips, rots = [], [], [], [], []
        for _ in range(batch_size):
            i = self._rng.randrange(len(self.gt))
            h, w, _ = self.lq.info(i)
            idxs.append(i)
            tops.append(self._rng.randint(0, h - lq_size))
            lefts.append(self._rng.randint(0, w - lq_size))
            hflips.append(self.opt.get("use_hflip", True)
                          and self._rng.random() < 0.5)
            rots.append(self.opt.get("use_rot", True)
                        and self._rng.random() < 0.5)
        lq = self.lq.crop_batch(idxs, tops, lefts, lq_size, hflips, rots)
        gt = self.gt.crop_batch(idxs, [t * scale for t in tops],
                                [l * scale for l in lefts], gt_size,
                                hflips, rots)
        return {"lq": lq.astype(np.float32) / 255.0,
                "gt": gt.astype(np.float32) / 255.0}
