"""LMDB dataset tooling (port of super_resolution_tpu/utils/lmdb_util.py;
ref: basicsr/utils/lmdb_util.py:9-199).

Writes the reference's protocol: an LMDB whose values are PNG-encoded
images keyed by name, and a meta_info.txt of '<key>.png (h,w,c)
<compress_level>' lines. Uses python-lmdb where it is installed, else the
port's pure-Python implementation of the format (``utils/mdb.py``); both
write the same files. The decode-free alternative is RawPack
(``data/rawpack_dataset.py``, ``tools/pack_dataset.py``).
"""

from __future__ import annotations

import os
from multiprocessing import Pool
from os import path as osp


def _require_lmdb():
    try:
        import lmdb
    except ImportError:
        # the port's pure-Python implementation of the LMDB format
        from super_resolution_tpu_torch.utils import mdb as lmdb
    return lmdb


def read_img_worker(path: str, key: str, compress_level: int):
    """Read + re-encode one image (ref: lmdb_util.py:135-156)."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img.ndim == 2:
        h, w = img.shape
        c = 1
    else:
        h, w, c = img.shape
    _, img_byte = cv2.imencode(
        ".png", img, [cv2.IMWRITE_PNG_COMPRESSION, compress_level])
    return key, img_byte, (h, w, c)


def make_lmdb_from_imgs(data_path, lmdb_path, img_path_list, keys,
                        batch: int = 5000, compress_level: int = 1,
                        multiprocessing_read: bool = False, n_thread: int = 40,
                        map_size=None):
    """Build an lmdb + meta_info.txt from an image folder
    (ref: lmdb_util.py:9-132)."""
    lmdb = _require_lmdb()
    import cv2  # noqa: F401

    assert len(img_path_list) == len(keys)
    assert lmdb_path.endswith(".lmdb")
    if osp.exists(lmdb_path):
        raise FileExistsError(f"Folder {lmdb_path} already exists.")

    dataset, shapes = {}, {}
    if multiprocessing_read:
        with Pool(n_thread) as pool:
            results = [pool.apply_async(
                read_img_worker,
                (osp.join(data_path, p), k, compress_level))
                for p, k in zip(img_path_list, keys)]
            for r in results:
                key, img_byte, shape = r.get()
                dataset[key] = img_byte
                shapes[key] = shape

    if map_size is None:
        img = cv2_imread(osp.join(data_path, img_path_list[0]))
        data_size = img.nbytes * len(img_path_list)
        map_size = data_size * 10

    env = lmdb.open(lmdb_path, map_size=map_size)
    txn = env.begin(write=True)
    os.makedirs(lmdb_path, exist_ok=True)
    with open(osp.join(lmdb_path, "meta_info.txt"), "w") as txt_file:
        for idx, (path, key) in enumerate(zip(img_path_list, keys)):
            if multiprocessing_read:
                img_byte = dataset[key]
                h, w, c = shapes[key]
            else:
                _, img_byte, (h, w, c) = read_img_worker(
                    osp.join(data_path, path), key, compress_level)
            txn.put(key.encode("ascii"), img_byte)
            txt_file.write(f"{key}.png ({h},{w},{c}) {compress_level}\n")
            if idx % batch == 0:
                txn.commit()
                txn = env.begin(write=True)
    txn.commit()
    env.close()


def cv2_imread(path):
    import cv2

    return cv2.imread(path, cv2.IMREAD_UNCHANGED)


class LmdbMaker:
    """Incremental lmdb writer (ref: lmdb_util.py:159-199)."""

    def __init__(self, lmdb_path, map_size=1024 ** 4, batch: int = 5000,
                 compress_level: int = 1):
        lmdb = _require_lmdb()
        assert lmdb_path.endswith(".lmdb")
        if osp.exists(lmdb_path):
            raise FileExistsError(f"Folder {lmdb_path} already exists.")
        self.lmdb_path = lmdb_path
        self.batch = batch
        self.compress_level = compress_level
        self.env = lmdb.open(lmdb_path, map_size=map_size)
        self.txn = self.env.begin(write=True)
        self.txt_file = open(osp.join(lmdb_path, "meta_info.txt"), "w")
        self.counter = 0

    def put(self, img_byte, key, img_shape):
        self.counter += 1
        self.txn.put(key.encode("ascii"), img_byte)
        h, w, c = img_shape
        self.txt_file.write(f"{key}.png ({h},{w},{c}) "
                            f"{self.compress_level}\n")
        if self.counter % self.batch == 0:
            self.txn.commit()
            self.txn = self.env.begin(write=True)

    def close(self):
        self.txn.commit()
        self.env.close()
        self.txt_file.close()
