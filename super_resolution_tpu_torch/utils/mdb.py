"""Pure-Python LMDB (data.mdb) reader and writer (a copy of
super_resolution_tpu/utils/mdb.py; numpy-free, so the copy is verbatim
below this docstring).

Neither python-lmdb nor liblmdb is needed: the reference's packed-dataset
path is LMDB (basicsr/utils/file_client.py:74-131,
paired_image_dataset.py:53-61, lmdb_util.py:9-199), and this module
implements the LMDB on-disk format from its specification — 4096-byte
pages, dual meta pages, B-tree branch/leaf pages, overflow pages for large
values — enough to build a database once (single writer, ascii keys,
binary values) and read it many times.

Layout implemented (per the LMDB file-format spec):

  page header   pgno u64 | pad u16 | flags u16 | lower u16 | upper u16
  meta page     header(P_META) + magic u32 (0xBEEFC0DE) | version u32 (1)
                | address u64 | mapsize u64 | db[FREE] | db[MAIN]
                | last_pg u64 | txnid u64
  MDB_db        pad u32 | flags u16 | depth u16 | branch_pages u64
                | leaf_pages u64 | overflow_pages u64 | entries u64
                | root u64
  leaf node     lo u16 | hi u16 (datasize = lo|hi<<16) | flags u16
                | ksize u16 | key | data        (or u64 overflow pgno
                when F_BIGDATA)
  branch node   lo u16 | hi u16 | flags u16 (48-bit child pgno) | ksize
                u16 | key   (first node of a branch page has ksize 0)
  overflow      header(P_OVERFLOW, lower field = page count u32) + raw

Node pointer offsets grow up from the header; node bodies grow down from
the page end; both offsets include the 16-byte header, nodes 2-byte
aligned — matching liblmdb so its tools can read these files.

``open()`` mirrors the python-lmdb API subset the datasets use
(env.begin / txn.put / txn.get / txn.commit / env.close, the subdir layout
with data.mdb).
"""

from __future__ import annotations

import builtins
import os
import struct
from os import path as osp

PAGESIZE = 4096
P_BRANCH, P_LEAF, P_OVERFLOW, P_META = 0x01, 0x02, 0x04, 0x08
F_BIGDATA = 0x01
MDB_MAGIC = 0xBEEFC0DE
MDB_VERSION = 1
P_INVALID = 0xFFFFFFFFFFFFFFFF

_PGHDR = struct.Struct("<QHHHH")          # pgno, pad, flags, lower, upper
_OVHDR = struct.Struct("<QHHI")           # pgno, pad, flags, page count
_DB = struct.Struct("<IHHQQQQQ")          # pad, flags, depth, branch, leaf,
                                          # overflow, entries, root
_META_TAIL = struct.Struct("<IIQQ")       # magic, version, address, mapsize
_NODEHDR = struct.Struct("<HHHH")         # lo, hi, flags, ksize


def _align2(n):
    return (n + 1) & ~1


# --------------------------------------------------------------- writer


class _Writer:
    def __init__(self, path: str, map_size: int):
        self.path = path
        self.map_size = map_size
        self.items: dict[bytes, bytes] = {}

    def put(self, key: bytes, value: bytes):
        self.items[bytes(key)] = bytes(value)

    # node body sizes (excluding the 2-byte pointer slot)
    @staticmethod
    def _leaf_node_size(k, v, big):
        return _align2(8 + len(k) + (8 if big else len(v)))

    @staticmethod
    def _branch_node_size(k):
        return _align2(8 + len(k))

    def flush(self):
        items = sorted(self.items.items())
        pages = []                       # list[bytes], index = pgno - 2
        n_overflow = 0

        def alloc(raw: bytes, stamp: bool = True) -> int:
            pages.append((raw, stamp))
            return len(pages) + 1        # pgno (0/1 are metas)

        def write_overflow(value: bytes) -> int:
            nonlocal n_overflow
            total = _OVHDR.size + len(value)
            count = -(-total // PAGESIZE)
            first = len(pages) + 2
            blob = _OVHDR.pack(first, 0, P_OVERFLOW, count) + value
            blob += b"\0" * (count * PAGESIZE - len(blob))
            for i in range(count):
                # only the first page has a header; continuation pages are
                # raw value bytes (liblmdb overflow chain layout)
                alloc(blob[i * PAGESIZE:(i + 1) * PAGESIZE], stamp=i == 0)
            n_overflow += count
            return first

        def build_page(flags: int, nodes: list[bytes]) -> bytes:
            lower = _PGHDR.size + 2 * len(nodes)
            upper = PAGESIZE
            body = bytearray(PAGESIZE)
            ptrs = []
            for node in reversed(nodes):
                upper -= _align2(len(node))
                body[upper:upper + len(node)] = node
                ptrs.append(upper)
            ptrs.reverse()
            _PGHDR.pack_into(body, 0, 0, 0, flags, lower, upper)
            struct.pack_into(f"<{len(nodes)}H", body, _PGHDR.size, *ptrs)
            return bytes(body)

        def page_fits(nodes_size: int, n_nodes: int) -> bool:
            return _PGHDR.size + 2 * n_nodes + nodes_size <= PAGESIZE

        # ---- leaves (key-order; overflow pages interleave naturally)
        leaf_entries = []                # (first_key, pgno)
        cur_nodes, cur_size, cur_first = [], 0, None
        max_inline = (PAGESIZE - _PGHDR.size) // 2 - 16

        def flush_leaf():
            nonlocal cur_nodes, cur_size, cur_first
            if cur_nodes:
                pg = alloc(build_page(P_LEAF, cur_nodes))
                leaf_entries.append((cur_first, pg))
                cur_nodes, cur_size, cur_first = [], 0, None

        n_leaf_nodes = 0
        for k, v in items:
            big = len(v) > max_inline
            if big:
                ov_pg = write_overflow(v)
                payload = struct.pack("<Q", ov_pg)
                lo, hi, fl = len(v) & 0xFFFF, len(v) >> 16, F_BIGDATA
            else:
                payload = v
                lo, hi, fl = len(v) & 0xFFFF, len(v) >> 16, 0
            node = _NODEHDR.pack(lo, hi, fl, len(k)) + k + payload
            size = _align2(len(node))
            if not page_fits(cur_size + size, len(cur_nodes) + 1):
                flush_leaf()
            if cur_first is None:
                cur_first = k
            cur_nodes.append(node)
            cur_size += size
            n_leaf_nodes += 1
        flush_leaf()

        n_leaf = len(leaf_entries)
        n_branch = 0
        depth = 1
        level = leaf_entries
        if not level:
            root = P_INVALID
        elif len(level) == 1:
            root = level[0][1]
        else:
            while len(level) > 1:
                depth += 1
                nxt, nodes, size, first = [], [], 0, None
                for i, (k, pg) in enumerate(level):
                    key = b"" if not nodes else k
                    node = _NODEHDR.pack(pg & 0xFFFF, (pg >> 16) & 0xFFFF,
                                         (pg >> 32) & 0xFFFF, len(key)) + key
                    ns = _align2(len(node))
                    if not page_fits(size + ns, len(nodes) + 1):
                        bp = alloc(build_page(P_BRANCH, nodes))
                        n_branch += 1
                        nxt.append((first, bp))
                        nodes, size, first = [], 0, None
                        # re-emit with empty key as new page's first node
                        node = _NODEHDR.pack(
                            pg & 0xFFFF, (pg >> 16) & 0xFFFF,
                            (pg >> 32) & 0xFFFF, 0)
                        ns = _align2(len(node))
                    if first is None:
                        first = k
                    nodes.append(node)
                    size += ns
                if nodes:
                    bp = alloc(build_page(P_BRANCH, nodes))
                    n_branch += 1
                    nxt.append((first, bp))
                level = nxt
            root = level[0][1]

        # ---- meta pages
        last_pg = len(pages) + 1
        free_db = _DB.pack(0, 0, 0, 0, 0, 0, 0, P_INVALID)
        main_db = _DB.pack(0, 0, depth if items else 0, n_branch, n_leaf,
                           n_overflow, n_leaf_nodes, root)

        def meta(pgno, txnid):
            body = bytearray(PAGESIZE)
            _PGHDR.pack_into(body, 0, pgno, 0, P_META, 0, 0)
            off = _PGHDR.size
            _META_TAIL.pack_into(body, off, MDB_MAGIC, MDB_VERSION, 0,
                                 self.map_size)
            off += _META_TAIL.size
            body[off:off + _DB.size] = free_db
            off += _DB.size
            body[off:off + _DB.size] = main_db
            off += _DB.size
            struct.pack_into("<QQ", body, off, last_pg, txnid)
            return bytes(body)

        with builtins.open(self.path, "wb") as f:
            f.write(meta(0, 0))
            f.write(meta(1, 1))
            for i, (raw, stamp) in enumerate(pages):
                # stamp the final pgno into header-bearing pages (tree
                # pages are built before their number is known); overflow
                # continuation pages are raw data — never touch them
                f.write(struct.pack("<Q", i + 2) + raw[8:] if stamp else raw)


# --------------------------------------------------------------- reader


class _Reader:
    def __init__(self, path: str):
        with builtins.open(path, "rb") as f:
            self.data = f.read()
        best = None
        for pgno in (0, 1):
            off = pgno * PAGESIZE
            magic, version, _, _ = _META_TAIL.unpack_from(
                self.data, off + _PGHDR.size)
            if magic != MDB_MAGIC:
                continue
            tail_off = off + _PGHDR.size + _META_TAIL.size + 2 * _DB.size
            last_pg, txnid = struct.unpack_from("<QQ", self.data, tail_off)
            main = _DB.unpack_from(
                self.data, off + _PGHDR.size + _META_TAIL.size + _DB.size)
            if best is None or txnid >= best[0]:
                best = (txnid, main)
        if best is None:
            raise ValueError(f"{path}: not an LMDB data file")
        _, _, self.depth, _, _, _, self.entries, self.root = best[1]

    def _page(self, pgno: int):
        off = pgno * PAGESIZE
        _, _, flags, lower, upper = _PGHDR.unpack_from(self.data, off)
        n = (lower - _PGHDR.size) // 2
        ptrs = struct.unpack_from(f"<{n}H", self.data, off + _PGHDR.size)
        return off, flags, ptrs

    def _node(self, page_off: int, ptr: int):
        off = page_off + ptr
        lo, hi, flags, ksize = _NODEHDR.unpack_from(self.data, off)
        key = self.data[off + 8:off + 8 + ksize]
        return lo, hi, flags, key, off + 8 + ksize

    def get(self, key: bytes):
        key = bytes(key)
        if self.root == P_INVALID:
            return None
        pgno = self.root
        for _ in range(self.depth - 1):          # branch levels
            page_off, flags, ptrs = self._page(pgno)
            assert flags & P_BRANCH
            child = None
            for ptr in ptrs:
                lo, hi, fl, k, _ = self._node(page_off, ptr)
                node_pg = lo | hi << 16 | fl << 32
                if k and k > key:
                    break
                child = node_pg
            pgno = child
        page_off, flags, ptrs = self._page(pgno)
        assert flags & P_LEAF
        for ptr in ptrs:
            lo, hi, fl, k, data_off = self._node(page_off, ptr)
            if k == key:
                dsize = lo | hi << 16
                if fl & F_BIGDATA:
                    ov_pg = struct.unpack_from("<Q", self.data, data_off)[0]
                    start = ov_pg * PAGESIZE + _OVHDR.size
                    return self.data[start:start + dsize]
                return self.data[data_off:data_off + dsize]
        return None

    def keys(self):
        """In-order key iteration (depth-first through the tree)."""
        if self.root == P_INVALID:
            return
        stack = [(self.root, self.depth)]
        while stack:
            pgno, level = stack.pop()
            page_off, flags, ptrs = self._page(pgno)
            if level > 1:
                children = []
                for ptr in ptrs:
                    lo, hi, fl, _, _ = self._node(page_off, ptr)
                    children.append(lo | hi << 16 | fl << 32)
                stack.extend((c, level - 1) for c in reversed(children))
            else:
                for ptr in ptrs:
                    _, _, _, k, _ = self._node(page_off, ptr)
                    yield k


# ----------------------------------------------------- python-lmdb shim


class _Transaction:
    def __init__(self, env, write: bool):
        self._env = env
        self._write = write

    def put(self, key: bytes, value: bytes):
        assert self._write, "read-only transaction"
        self._env._writer.put(key, value)
        return True

    def get(self, key: bytes, default=None):
        r = self._env._reader()
        v = r.get(key) if r is not None else None
        return default if v is None else v

    def commit(self):
        if self._write:
            self._env._writer.flush()
            self._env._cached_reader = None

    def abort(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.commit()


class Environment:
    def __init__(self, path: str, map_size: int = 10 * 1024 ** 2,
                 subdir: bool = True, readonly: bool = False, **kwargs):
        self._data_path = osp.join(path, "data.mdb") if subdir else path
        self.readonly = readonly
        self._cached_reader = None
        if readonly:
            if not osp.exists(self._data_path):
                raise FileNotFoundError(self._data_path)
            self._writer = None
        else:
            if subdir:
                os.makedirs(path, exist_ok=True)
            self._writer = _Writer(self._data_path, map_size)
            if osp.exists(self._data_path):
                r = _Reader(self._data_path)
                for k in r.keys():
                    self._writer.put(k, r.get(k))

    def _reader(self):
        if self._cached_reader is None and osp.exists(self._data_path):
            self._cached_reader = _Reader(self._data_path)
        return self._cached_reader

    def begin(self, write: bool = False, **kwargs):
        if write and self.readonly:
            raise PermissionError("read-only environment")
        return _Transaction(self, write)

    def stat(self):
        r = self._reader()
        return {"entries": r.entries if r else 0, "psize": PAGESIZE}

    def close(self):
        if self._writer is not None and self._writer.items:
            self._writer.flush()


def open(path, **kwargs):  # noqa: A001 - mirrors lmdb.open
    kwargs.pop("lock", None)
    kwargs.pop("readahead", None)
    kwargs.pop("meminit", None)
    kwargs.pop("max_readers", None)
    return Environment(path, **kwargs)
