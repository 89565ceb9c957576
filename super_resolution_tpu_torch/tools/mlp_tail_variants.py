"""Time variants of the bf16 MLP tail kernels (``csrc/mlp_tail.cu``,
``mma_mlp_tail_kernel`` and ``mma_hab_tail_kernel``) on one card: where
their time goes, without ncu.

A variant is the source with some text replaced: a constant changed, or a
part of a step knocked out (``no_*``; their outputs are wrong by design).
All variants are compiled at once, each into a shared library of its own
under the package's ``_build/``, and the C entry ``sr_mma_mlp_tail`` of each
is timed with CUDA events (median of 20 calls) on seeded bf16 inputs of a
chunk of four 160 x 160 tiles at the widths of the paths: the flagship's C
180 / hidden 360 in all three forms and as fused_hab_block's tail
(``sr_mma_hab_tail``, the head concat projected in front), SwinIR-light's
60 / 120, SwinIR-L's 240 / 480 and the zoo's SwinIR 180 / 720. The
variants that compute the function are held against the plain version
within ``chip_smoke.TOL_BF16``. Each line prints a variant's registers and
spills (ptxas) at each accumulator width of ``mma_mlp_tail_kernel``, then
its times.

    python3 -m super_resolution_tpu_torch.tools.mlp_tail_variants
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys

from super_resolution_tpu_torch.ops.cuda_build import (BUILD_DIR, CSRC_DIR,
                                                       MAX_DYNAMIC_SMEM,
                                                       NVCC_FLAGS, _nvcc)

_GELU = ("  const float e = 1.f - poly * __expf(-az * az);\n"
         "  return 0.5f * h * (1.f + copysignf(e, z));")
_FC1 = ("        mma::mma_bf16(hs[2 * np], af, b[0], b[1]);\n"
        "        mma::mma_bf16(hs[2 * np + 1], af, b[2], b[3]);")
_FC2 = ("        mma::mma_bf16(acc[2 * np], gf[q], b[0], b[1]);\n"
        "        mma::mma_bf16(acc[2 * np + 1], gf[q], b[2], b[3]);")
_READ = "      float2 v = pair_at<PAIRS>(row_s[h] + c, ok0, ok1);"
# name -> [(text, replacement)]
VARIANTS = {
    "kernel": [],
    "stages_4": [("constexpr int kStages = 3;", "constexpr int kStages = 4;")],
    "hid_panel_16": [("constexpr int kHidPanel = 32;",
                      "constexpr int kHidPanel = 16;")],
    "gelu_erff": [(_GELU, "  return 0.5f * h * (1.f + erff(z));")],
    "no_gelu": [(_GELU, "  return h;")],
    "no_fc1": [(_FC1, "")],
    "no_fc2": [(_FC2, "")],
    "no_weight_copies": [("    if (p < steps) {", "    if (p < 0) {")],
    "proj_step_64": [("constexpr int kProjStep = 32;",
                      "constexpr int kProjStep = 64;")],
    "no_row_reads": [(_READ, "      float2 v = make_float2(0.f, 0.f);"),
                     ("if (SUM3) {\n        const float2 va",
                      "if (false) {\n        const float2 va")],
}
EXACT = ("kernel", "stages_4", "hid_panel_16", "gelu_erff", "proj_step_64")
# (C, hidden, form) at the chunk of four 160 x 160 tiles
CASES = [(180, 360, "mlp_block"), (180, 360, "sum3"), (180, 360, "shifted"),
         (180, 360, "hab"),
         (60, 120, "mlp_block"), (60, 120, "sum3"), (240, 480, "mlp_block"),
         (240, 480, "sum3"), (180, 720, "mlp_block")]


def sources(source: str, variants: dict) -> dict:
    """name -> the text of csrc/``source`` with each variant's replacements;
    raises where a text to replace is not in the source."""
    base = (CSRC_DIR / source).read_text()
    out = {}
    for name, subs in variants.items():
        text = base
        for old, new in subs:
            if old not in text:
                raise KeyError(f"{name}: {old!r} is not in {source}")
            text = text.replace(old, new)
        out[name] = text
    return out


def build(source: str = "mlp_tail.cu", variants: dict = VARIANTS,
          kernel: str = "mma_mlp_tail_kernel", entries: dict = None) -> dict:
    """name -> (ctypes library, ptxas summary of ``kernel``'s instances),
    each variant of csrc/``source`` compiled alone into a library of its
    own, all in parallel; ``entries``: C entry -> argtypes."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if entries is None:
        entries = {"sr_mma_mlp_tail": [P] * 10 + [I] * 7 + [F] * 3 + [P],
                   "sr_mma_hab_tail": [P] * 12 + [I] * 5 + [F] * 2 + [P],
                   "sr_mma_mlp_tail_smem": [I]}
    root = BUILD_DIR / f"{source.split('.')[0]}_variants"
    procs = {}
    for name, text in sources(source, variants).items():
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        (d / source).write_text(text)
        procs[name] = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I",
             str(CSRC_DIR), "-o", str(d / "lib.so"), str(d / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        lines = proc.communicate()[0].splitlines()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n" + "\n".join(lines))
        usage = []
        for i, line in enumerate(lines):
            m = re.search(rf"{kernel}ILi(\d+)E", line)
            if m and "Compiling" in line:
                near = " ".join(lines[i + 1:i + 6])
                regs = re.search(r"Used (\d+) registers", near).group(1)
                spill = re.search(r"(\d+) bytes spill stores", near).group(1)
                usage.append(f"NT {m.group(1)}: {regs} registers, {spill} B "
                             f"spilled")
        lib = ctypes.CDLL(str(root / name / "lib.so"))
        for entry, argtypes in entries.items():
            getattr(lib, entry).argtypes = argtypes
        libs[name] = (lib, "; ".join(usage))
    return libs


def main() -> int:
    import torch

    import chip_smoke
    from super_resolution_tpu_torch.ops import cuda_ffn as cf

    if not torch.cuda.is_available():
        print("mlp_tail_variants: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs = build()
    for name, (_, usage) in libs.items():
        print(f"{name}: {usage}", flush=True)
    b, hw, dt = 4, 160, torch.bfloat16
    stream = torch.cuda.current_stream().cuda_stream
    for c, hid, form in CASES:
        t = chip_smoke._device_randn(dt, c + hid)
        x, a, cv = t(b, hw, hw, c), t(b, hw, hw, c), t(b, hw, hw, c)
        tail = (1.0 + t(c, s=0.1), t(c, s=0.1), t(c, hid, s=c ** -0.5),
                t(hid, s=0.1), t(hid, c, s=hid ** -0.5), t(c, s=0.1))
        sum3, ss = int(form != "mlp_block"), 4 if form == "shifted" else 0
        # the hab form: a is the head concat, projected by wp, bp
        wp, bp = t(c, c, s=c ** -0.5), t(c, s=0.1)
        attn = (a.float() @ wp.float() + bp.float()).to(dt)
        ref = (cf.mlp_block_reference(x, *tail) if not sum3 else
               cf.mlp_block_sum3_shifted_reference(x, a, cv, *tail, 0.01, 4)
               if ss else cf.mlp_block_sum3_reference(
                   x, attn if form == "hab" else a, cv, *tail, 0.01))
        tol = chip_smoke.TOL_BF16 * max(1.0, ref.float().abs().max().item())
        out = torch.empty_like(x)
        line = f"C {c} hidden {hid} {form}:"
        for name, (lib, _) in libs.items():
            if lib.sr_mma_mlp_tail_smem(c) > MAX_DYNAMIC_SMEM:
                line += f" {name} -;"
                continue

            def run(lib=lib, name=name):
                if form == "hab":
                    err = lib.sr_mma_hab_tail(
                        x.data_ptr(), a.data_ptr(), cv.data_ptr(),
                        wp.data_ptr(), bp.data_ptr(),
                        *(v.data_ptr() for v in tail), out.data_ptr(), b,
                        hw, hw, c, hid, 0.01, 1e-5, stream)
                else:
                    err = lib.sr_mma_mlp_tail(
                        x.data_ptr(), a.data_ptr(), cv.data_ptr(),
                        *(v.data_ptr() for v in tail), out.data_ptr(), b,
                        hw, hw, c, hid, sum3, ss, 0.01, 1e-5, 1.0, stream)
                if err:
                    raise RuntimeError(f"{name}: cudaError_t {err}")
            run()
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            if name in EXACT and not err <= tol:
                raise AssertionError(f"{name} at C {c}, hidden {hid}, "
                                     f"{form}: {err} > {tol}")
            ms = chip_smoke.time_ms(run, reps=20, warmup=3)
            line += f" {name} {ms:.4f};"
        print(line, flush=True)
        del x, a, cv, tail, ref, out, wp, bp, attn
    return 0


if __name__ == "__main__":
    sys.exit(main())
