"""Compare the ptxas report of every kernel between two trees of this
repository: which kernels a change added or removed and whose registers,
stack or spills moved.

Each tree's ``csrc/`` is built by its own ``ops/cuda_build.py`` with
ptxas's report (``build(verbose=True)``; the library is rebuilt), both
trees at once. A kernel is matched across trees by its mangled name, with
the per-file hashes of anonymous namespaces taken out. Each line gives
SAME, DIFF, NEW (only in the second tree) or GONE (only in the first) and
the kernel's name; the lines of the tensor-core kernels (``mma_*``) and of
every kernel that is not SAME follow. Needs ``nvcc``:

    python3 -m super_resolution_tpu_torch.tools.ptxas_diff unpacked/parent .
"""

from __future__ import annotations

import concurrent.futures
import importlib.util
import re
import sys


def build_log(root: str) -> str:
    """ptxas's report of a fresh build of ``root``'s kernels."""
    spec = importlib.util.spec_from_file_location(
        f"cuda_build_{abs(hash(root))}",
        f"{root}/super_resolution_tpu_torch/ops/cuda_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.library_path().unlink(missing_ok=True)
    return mod.build(verbose=True)[1]


def report(log: str) -> dict:
    """Kernel -> its stack and register lines."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = re.sub(r"_cu_[0-9a-f]{8}", "_cu_X", re.sub(
                r"_GLOBAL__N__[0-9a-f]{8}_", "_GLOBAL__N__X_", m.group(1)))
            out[fn] = []
        elif fn and ("stack frame" in line or "Used" in line):
            out[fn].append(line.split(":", 1)[-1].strip())
    return out


def main(first: str, second: str) -> int:
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        a, b = (report(log) for log in ex.map(build_log, (first, second)))
    for fn in sorted(set(a) | set(b)):
        la, lb = a.get(fn), b.get(fn)
        tag = ("SAME" if la == lb else "NEW " if la is None
               else "GONE" if lb is None else "DIFF")
        print(f"{tag} {fn}")
        if tag != "SAME":
            print(f"     {first}: {la}\n     {second}: {lb}")
        elif "mma" in fn:
            print(f"     {lb}")
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 3:
        print(__doc__.strip().splitlines()[-1], file=sys.stderr)
        sys.exit(2)
    sys.exit(main(*sys.argv[1:]))
