"""The port's host-side native code, bound with ctypes (port of
super_resolution_tpu/native/__init__.py).

``csrc/rawpack.cpp`` is RawPack's reader: an mmap'd packed dataset and a
parallel crop sampler (``data/rawpack_dataset.py``). It is built with g++
on first use, from the checkout alone, into ``_build/`` (listed in
.gitignore); the library's name carries a hash of the source and flags, so
an edited source is rebuilt and a stale library never loaded. A failed
build raises: nothing reads RawPack files another way.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

from super_resolution_tpu_torch.ops.cuda_build import BUILD_DIR, CSRC_DIR

SOURCE = CSRC_DIR / "rawpack.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")

_LIB = None


def library_path():
    """Path of the shared library for the current source and flags."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"librawpack-{h.hexdigest()[:16]}.so"


def build_native() -> str:
    """Compile csrc/rawpack.cpp unless the library for this source exists.
    Returns its path; raises RuntimeError when g++ is missing or fails."""
    lib = library_path()
    if lib.exists():
        return str(lib)
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o",
                               str(tmp)], capture_output=True, text=True)
    except OSError as exc:
        raise RuntimeError(f"g++ could not run: {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SOURCE.name}:\n"
                           f"{proc.stderr}")
    os.replace(tmp, lib)
    return str(lib)


def get_lib() -> ctypes.CDLL:
    """The RawPack library, built and loaded on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build_native())
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.rawpack_open.restype = p
        lib.rawpack_open.argtypes = [ctypes.c_char_p]
        lib.rawpack_len.restype = i64
        lib.rawpack_len.argtypes = [p]
        lib.rawpack_info.restype = ctypes.c_int
        lib.rawpack_info.argtypes = [p, i64] + [ctypes.POINTER(i64)] * 3
        lib.rawpack_read.restype = ctypes.c_int
        lib.rawpack_read.argtypes = [p, i64, p]
        lib.rawpack_crop_batch.restype = ctypes.c_int
        lib.rawpack_crop_batch.argtypes = [p, i64, p, p, p, i64, p, p, p,
                                           i64]
        lib.rawpack_close.argtypes = [p]
        _LIB = lib
    return _LIB
