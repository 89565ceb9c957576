"""The port's storage backends against the JAX package, on the CPU:

- LMDB: the port's pure-Python ``mdb`` writes the same ``data.mdb`` bytes
  as JAX's for the same puts (one leaf, a multi-page B-tree, overflow
  values), and each reader reads the other's files; ``make_lmdb_from_imgs``
  writes the same ``meta_info.txt`` and ``data.mdb``; ``PairedImageDataset``
  on ``io_backend: lmdb`` yields JAX's items;
- memcached: ``MemcachedBackend.get`` equals JAX's against a loopback
  server thread that speaks the text protocol, the 250-byte key digest
  and a miss included;
- RawPack: ``pack_folder`` writes JAX's bytes; ``crop_batch`` equals numpy
  crops with flips and rotations and JAX's reader, and rejects bad bounds;
  ``RawPackPairedDataset``'s items and ``sample_batch`` equal JAX's for a
  seed; the library is the port's, built by g++ into ``_build/``.
"""

import os
import socket
import threading

import cv2
import numpy as np
import pytest

from torch_threads import few_torch_threads  # noqa: F401


def _put_all(mdb, path, items):
    env = mdb.open(path, map_size=10 * 1024 ** 2)
    with env.begin(write=True) as txn:
        for k, v in items.items():
            txn.put(k, v)
    env.close()


def _items(kind):
    rng = np.random.default_rng({"small": 0, "multipage": 1,
                                 "overflow": 2}[kind])
    if kind == "small":
        return {b"a": b"alpha", b"b": b"beta", b"zz": b"x" * 100}
    if kind == "multipage":
        return {f"key_{i:06d}".encode(): rng.bytes(200)
                for i in rng.permutation(500)}
    return {b"big1": rng.bytes(3 * 4096 + 17), b"small": b"s",
            b"big2": rng.bytes(4096), b"big3": rng.bytes(100_000)}


@pytest.mark.parametrize("kind", ["small", "multipage", "overflow"])
def test_mdb_bytes_and_cross_reads(kind, tmp_path):
    from super_resolution_tpu.utils import mdb as j_mdb
    from super_resolution_tpu_torch.utils import mdb

    items = _items(kind)
    port, jax_ = str(tmp_path / "port.lmdb"), str(tmp_path / "jax.lmdb")
    _put_all(mdb, port, items)
    _put_all(j_mdb, jax_, items)
    with open(os.path.join(port, "data.mdb"), "rb") as f:
        got = f.read()
    with open(os.path.join(jax_, "data.mdb"), "rb") as f:
        assert got == f.read()
    if kind == "multipage":
        assert mdb._Reader(os.path.join(port, "data.mdb")).depth >= 2
    for reader, path in ((mdb, jax_), (j_mdb, port)):
        env = reader.open(path, readonly=True)
        with env.begin() as txn:
            for k, v in items.items():
                assert txn.get(k) == v
            assert txn.get(b"missing") is None


@pytest.fixture(scope="module")
def image_folders(tmp_path_factory):
    """GT PNGs and their x2 LQ, three pairs of different sizes."""
    root = tmp_path_factory.mktemp("backend_images")
    gt, lq = root / "gt", root / "lq"
    gt.mkdir(), lq.mkdir()
    rng = np.random.default_rng(3)
    for i, (h, w) in enumerate([(40, 48), (48, 40), (44, 52)]):
        img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        cv2.imwrite(str(gt / f"im{i}.png"), img)
        cv2.imwrite(str(lq / f"im{i}.png"),
                    cv2.resize(img, (w // 2, h // 2),
                               interpolation=cv2.INTER_AREA))
    return str(gt), str(lq)


def _make_lmdb(make, folder, out):
    names = sorted(os.listdir(folder))
    make(folder, out, names, [os.path.splitext(n)[0] for n in names])


def test_make_lmdb_and_paired_dataset(image_folders, tmp_path):
    from super_resolution_tpu.data.paired_dataset import \
        PairedImageDataset as JPaired
    from super_resolution_tpu.utils.lmdb_util import \
        make_lmdb_from_imgs as j_make
    from super_resolution_tpu_torch.data import build_dataset
    from super_resolution_tpu_torch.utils.lmdb_util import \
        make_lmdb_from_imgs

    roots = {}
    for pkg, make in (("port", make_lmdb_from_imgs), ("jax", j_make)):
        for side, folder in zip(("gt", "lq"), image_folders):
            out = str(tmp_path / pkg / f"{side}.lmdb")
            os.makedirs(os.path.dirname(out), exist_ok=True)
            _make_lmdb(make, folder, out)
            roots[pkg, side] = out
    for side in ("gt", "lq"):
        for name in ("meta_info.txt", "data.mdb"):
            with open(os.path.join(roots["port", side], name), "rb") as f:
                got = f.read()
            with open(os.path.join(roots["jax", side], name), "rb") as f:
                assert got == f.read(), (side, name)
    assert open(os.path.join(roots["port", "gt"], "meta_info.txt")).read(
        ).splitlines()[0] == "im0.png (40,48,3) 1"

    for phase in ("val", "train"):
        opt = dict(name="Lmdb", type="PairedImageDataset", phase=phase,
                   scale=2, gt_size=16, dataroot_gt=roots["port", "gt"],
                   dataroot_lq=roots["port", "lq"],
                   io_backend={"type": "lmdb"})
        got, ref = build_dataset(opt), JPaired(dict(opt))
        got.seed(5)
        ref.seed(5)
        assert got.paths == ref.paths
        assert [p["gt_path"] for p in got.paths] == ["im0", "im1", "im2"]
        for i in range(len(ref)):
            a, b = got[i], ref[i]
            assert a.keys() == b.keys()
            for k in a:
                if isinstance(a[k], np.ndarray):
                    np.testing.assert_array_equal(a[k], b[k])
                else:
                    assert a[k] == b[k]


class _Memcached(threading.Thread):
    """A loopback memcached that answers ``get`` over the text protocol
    from a dict of encoded keys."""

    def __init__(self, store: dict):
        super().__init__(daemon=True)
        self.store = store
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(4)
        self.addr = "127.0.0.1:%d" % self.sock.getsockname()[1]

    def run(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn):
        buf = b""
        with conn:
            while True:
                while b"\r\n" not in buf:
                    chunk = conn.recv(65536)
                    if not chunk:
                        return
                    buf += chunk
                line, buf = buf.split(b"\r\n", 1)
                key = line.split()[1]
                if key in self.store:
                    value = self.store[key]
                    conn.sendall(b"VALUE %s 0 %d\r\n" % (key, len(value))
                                 + value + b"\r\nEND\r\n")
                else:
                    conn.sendall(b"END\r\n")

    def close(self):
        self.sock.close()


def test_memcached_backend_matches_jax():
    from super_resolution_tpu.utils.file_client import \
        MemcachedBackend as JBackend
    from super_resolution_tpu_torch.utils.file_client import (
        FileClient, MemcachedBackend)

    rng = np.random.default_rng(4)
    paths = ["/data/im0.png", "/data/a dir/im 1.png", "/d/" + "x" * 300,
             "/d/" + "x" * 299 + "y"]
    # a value holding the protocol's end marker must not end the read
    values = [rng.bytes(100), b"END\r\n" + rng.bytes(70_000), rng.bytes(5),
              rng.bytes(6)]
    keys = [MemcachedBackend._encode_key(p) for p in paths]
    assert keys == [JBackend._encode_key(p) for p in paths]
    assert keys[1] == b"/data/a%20dir/im%201.png"
    assert len(keys[2]) == 250 and keys[2] != keys[3]
    server = _Memcached(dict(zip(keys, values)))
    server.start()
    try:
        port = FileClient("memcached", server=server.addr)
        ref = JBackend(server=server.addr)
        for p, v in zip(paths, values):
            assert port.get(p) == ref.get(p) == v
        for backend in (port.client, ref):
            with pytest.raises(KeyError, match="miss"):
                backend.get("/data/missing.png")
    finally:
        server.close()


@pytest.fixture(scope="module")
def packs(image_folders, tmp_path_factory):
    """(port packs, JAX packs, the GT images as RGB): each folder packed by
    both packages."""
    from super_resolution_tpu.data.rawpack_dataset import \
        pack_folder as j_pack
    from super_resolution_tpu_torch.data.rawpack_dataset import pack_folder

    root = tmp_path_factory.mktemp("packs")
    out = {}
    for pkg, pack in (("port", pack_folder), ("jax", j_pack)):
        for side, folder in zip(("gt", "lq"), image_folders):
            path = str(root / f"{pkg}_{side}.srpk")
            assert pack(folder, path) == 3
            out[pkg, side] = path
    gts = [cv2.imread(os.path.join(image_folders[0], f"im{i}.png"))[:, :, ::-1]
           for i in range(3)]
    return out, gts


def test_pack_bytes_and_library(packs):
    from super_resolution_tpu_torch import native
    from super_resolution_tpu_torch.ops.cuda_build import BUILD_DIR

    paths, _ = packs
    for side in ("gt", "lq"):
        with open(paths["port", side], "rb") as f:
            got = f.read()
        with open(paths["jax", side], "rb") as f:
            assert got == f.read()
    lib = native.get_lib()
    assert os.path.dirname(lib._name) == str(BUILD_DIR)
    assert os.path.basename(lib._name).startswith("librawpack-")
    assert native.library_path().exists()


def test_crop_batch_matches_numpy_and_jax(packs):
    from super_resolution_tpu.data.rawpack_dataset import \
        RawPackReader as JReader
    from super_resolution_tpu_torch.data.rawpack_dataset import RawPackReader

    paths, gts = packs
    r, jr = RawPackReader(paths["port", "gt"]), JReader(paths["jax", "gt"])
    assert len(r) == 3 and [r.info(i) for i in range(3)] == [
        g.shape for g in gts]
    for i in range(3):
        np.testing.assert_array_equal(r.read(i), gts[i])
    idxs, tops, lefts = [0, 1, 2, 0], [0, 3, 7, 10], [5, 0, 11, 2]
    hflips, rots, crop = [0, 1, 0, 1], [0, 0, 1, 1], 16
    out = r.crop_batch(idxs, tops, lefts, crop, hflips, rots, n_threads=3)
    np.testing.assert_array_equal(
        out, jr.crop_batch(idxs, tops, lefts, crop, hflips, rots))
    for k in range(4):
        ref = gts[idxs[k]][tops[k]:tops[k] + crop, lefts[k]:lefts[k] + crop]
        # data/transforms.py's order: the flip, then the transpose
        if hflips[k]:
            ref = ref[:, ::-1]
        if rots[k]:
            ref = ref.transpose(1, 0, 2)
        np.testing.assert_array_equal(out[k], ref)
    for bad in (dict(idxs=[0, 3]), dict(tops=[0, 48 - 15]),
                dict(lefts=[-1, 0])):
        args = {**dict(idxs=[0, 1], tops=[0, 0], lefts=[0, 0]), **bad}
        with pytest.raises(ValueError, match="bad index/crop"):
            r.crop_batch(args["idxs"], args["tops"], args["lefts"], crop)
    # lengths are checked before a pointer reaches the library
    with pytest.raises(ValueError, match="other lengths"):
        r.crop_batch([0, 1], [0, 0], [0, 0], crop, hflips=[0])


def test_rawpack_dataset_matches_jax(packs):
    from super_resolution_tpu.data.rawpack_dataset import \
        RawPackPairedDataset as JDataset
    from super_resolution_tpu_torch.data import build_dataset

    paths, _ = packs
    opt = dict(name="Packs", type="RawPackPairedDataset",
               gt_pack=paths["port", "gt"], lq_pack=paths["port", "lq"],
               scale=2, gt_size=16, use_hflip=True, use_rot=True)
    got, ref = build_dataset(opt), JDataset(dict(opt))
    got.seed(7)
    ref.seed(7)
    for i in range(len(ref)):
        a, b = got[i], ref[i]
        assert a.keys() == b.keys() and a["gt"].shape == (16, 16, 3)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    a, b = got.sample_batch(5), ref.sample_batch(5)
    assert a["lq"].shape == (5, 8, 8, 3)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
