"""Storage backends (port of super_resolution_tpu/utils/file_client.py;
ref: basicsr/utils/file_client.py:22-167).

Backends: disk (the default); rawpack (the decode-free packed format of
``data/rawpack_dataset.py``, read through the port's native reader); lmdb
(python-lmdb where it is installed, else the port's pure-Python
``utils/mdb.py``); memcached (the text protocol over a socket, no client
library).
"""

from __future__ import annotations

from typing import Any, Dict


class DiskBackend:
    def get(self, filepath: str, client_key: str | None = None) -> bytes:
        with open(filepath, "rb") as f:
            return f.read()

    def get_text(self, filepath: str) -> str:
        with open(filepath, "r") as f:
            return f.read()


class RawPackBackend:
    """Reads whole items from RawPack files by integer key or 'name' via an
    optional meta listing."""

    def __init__(self, db_paths, client_keys="default"):
        from super_resolution_tpu_torch.data.rawpack_dataset import \
            RawPackReader

        if isinstance(client_keys, str):
            client_keys = [client_keys]
        if isinstance(db_paths, str):
            db_paths = [db_paths]
        self._readers = {k: RawPackReader(p)
                         for k, p in zip(client_keys, db_paths)}

    def get(self, idx, client_key: str = "default"):
        return self._readers[client_key].read(int(idx))


class LmdbBackend:
    """Multi-env lmdb reader keyed by client (ref: file_client.py:74-131)."""

    def __init__(self, db_paths, client_keys="default", readonly=True,
                 lock=False, readahead=False, **kwargs):
        try:
            import lmdb
        except ImportError:
            # the port's pure-Python implementation of the LMDB format
            from super_resolution_tpu_torch.utils import mdb as lmdb
        if isinstance(client_keys, str):
            client_keys = [client_keys]
        if isinstance(db_paths, (list, tuple)):
            db_paths = [str(v) for v in db_paths]
        else:
            db_paths = [str(db_paths)]
        assert len(client_keys) == len(db_paths)
        self._client = {k: lmdb.open(p, readonly=readonly, lock=lock,
                                     readahead=readahead, **kwargs)
                        for k, p in zip(client_keys, db_paths)}

    def get(self, filepath, client_key="default"):
        client = self._client[client_key]
        with client.begin(write=False) as txn:
            return txn.get(str(filepath).encode("ascii"))


class MemcachedBackend:
    """Minimal memcached reader over the text protocol (ref:
    file_client.py:22-46 — the reference wraps the `mc` client lib; this
    implementation speaks the protocol directly over a socket, so no
    binding is needed). Keys are the file paths (percent-encoded: the
    protocol forbids spaces/control chars in keys)."""

    def __init__(self, server: str = "127.0.0.1:11211",
                 timeout: float = 3.0, **kwargs):
        host, _, port = server.partition(":")
        self._addr = (host, int(port or 11211))
        self._timeout = timeout
        self._sock = None

    def _connect(self):
        import socket

        s = socket.create_connection(self._addr, timeout=self._timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return s

    @staticmethod
    def _encode_key(filepath) -> bytes:
        from urllib.parse import quote

        key = quote(str(filepath), safe="/.-_").encode("ascii")
        if len(key) > 250:
            # memcached keys are capped at 250 bytes; a plain truncation
            # would let two long paths collide, so replace the overflow
            # with a digest of the full path (standard client behavior).
            import hashlib

            digest = hashlib.md5(key).hexdigest().encode("ascii")
            key = key[: 250 - len(digest) - 1] + b"#" + digest
        return key

    def get(self, filepath, client_key=None):
        if self._sock is None:
            self._sock = self._connect()
        key = self._encode_key(filepath)
        try:
            self._sock.sendall(b"get " + key + b"\r\n")
            # Parse the response header first: either 'END\r\n' (miss) or
            # 'VALUE <key> <flags> <bytes>\r\n'. Only then read the exact
            # data length — a binary value containing b'END\r\n' must not
            # terminate the read early.
            buf = b""
            while b"\r\n" not in buf:
                chunk = self._sock.recv(65536)
                if not chunk:
                    raise ConnectionError("memcached closed the connection")
                buf += chunk
            header, rest = buf.split(b"\r\n", 1)
            if header == b"END":
                raise KeyError(f"memcached miss for key {key!r}")
            if not header.startswith(b"VALUE "):
                raise ConnectionError(
                    f"unexpected memcached response: {header!r}")
            # VALUE <key> <flags> <bytes> [<cas>]
            nbytes = int(header.split()[3])
            need = nbytes + len(b"\r\nEND\r\n")
            while len(rest) < need:
                chunk = self._sock.recv(65536)
                if not chunk:
                    raise ConnectionError("memcached closed the connection")
                rest += chunk
        except OSError:
            self._sock = None
            raise
        if rest[nbytes:need] != b"\r\nEND\r\n":
            # drop the connection: the stream is desynchronized and a
            # later get() on the same socket would parse stale bytes as
            # the wrong key's value
            self._sock = None
            raise ConnectionError("malformed memcached data block "
                                  f"(trailer {rest[nbytes:need]!r})")
        data = rest[:nbytes]
        assert len(data) == nbytes
        return data


class FileClient:
    """Dispatch by backend name (ref: file_client.py:132-167)."""

    _backends = {
        "disk": DiskBackend,
        "rawpack": RawPackBackend,
        "lmdb": LmdbBackend,
        "memcached": MemcachedBackend,
    }

    def __init__(self, backend: str = "disk", **kwargs):
        if backend not in self._backends:
            raise ValueError(f"Backend {backend} not supported. "
                             f"Available: {sorted(self._backends)}")
        self.backend = backend
        self.client = self._backends[backend](**kwargs) if kwargs else \
            self._backends[backend]()

    def get(self, filepath, client_key: str | None = None):
        if self.backend in ("rawpack", "lmdb"):
            # multi-env backends dispatch on the client key
            # (ref: file_client.py:158-162)
            return self.client.get(filepath, client_key or "default")
        return self.client.get(filepath)

    def get_text(self, filepath):
        return self.client.get_text(filepath)
