"""Time variants of the bf16 gated FFN kernel (``csrc/gated_dconv_ffn.cu``,
``mma_gated_dconv_ffn_kernel``) on one card: where its time goes, without
ncu, and which panel and fc1 grouping to keep.

A variant is the source with some text replaced (``mlp_tail_variants``'s
way): a constant changed, or a part knocked out (``no_*``; their outputs
are wrong by design). All variants are compiled at once, each into a
shared library of its own under the package's ``_build/``, and the C entry
``sr_mma_gated_dconv_ffn`` of each is timed with CUDA events (median of 20
calls) on seeded bf16 inputs of a chunk of four 160 x 160 tiles: the
fork's block (C / M 180 / 360), HAT-S's (144 / 288) and the bare entry at
C_out 36. The variants that compute the function are held against the
plain version within ``chip_smoke.TOL_BF16``. Each line prints a variant's
registers and spills (ptxas) at each accumulator width, then its times.

    python3 -m super_resolution_tpu_torch.tools.gated_ffn_variants
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

from super_resolution_tpu_torch.ops.cuda_build import MAX_DYNAMIC_SMEM
from super_resolution_tpu_torch.tools.mlp_tail_variants import build

_FC1 = ("            mma::mma_bf16(hacc[i][2 * np], af, bw[np][0], "
        "bw[np][1]);\n            mma::mma_bf16(hacc[i][2 * np + 1], af, "
        "bw[np][2], bw[np][3]);")
_FC2 = ("        mma::mma_bf16(acc[2 * np], gf, bw[0], bw[1]);\n"
        "        mma::mma_bf16(acc[2 * np + 1], gf, bw[2], bw[3]);")
_TAPS = "#pragma unroll\n        for (int dy = 0; dy < 3; ++dy)"
_LOAD = "    if (p < panels) {\n      const int j0 = p * kPanelCh;"
# name -> [(text, replacement)]
VARIANTS = {
    "kernel": [],
    "fc1_tiles_1": [("constexpr int kFc1Tiles = 3;",
                     "constexpr int kFc1Tiles = 1;")],
    "panel_16": [("constexpr int kPanelCh = 32;",
                  "constexpr int kPanelCh = 16;")],
    "panel_48": [("constexpr int kPanelCh = 32;",
                  "constexpr int kPanelCh = 48;")],
    "no_fc1": [(_FC1, "")],
    "no_fc2": [(_FC2, "")],
    "no_depthwise": [(_TAPS, "#pragma unroll\n        for (int dy = 0; "
                             "dy < 0; ++dy)")],
    "no_weight_copies": [(_LOAD, "    if (p < 0) {\n      const int j0 = "
                                 "p * kPanelCh;")],
}
EXACT = ("kernel", "fc1_tiles_1", "panel_16", "panel_48")
# (C, M, C_out, block) at the chunk of four 160 x 160 tiles
CASES = [(180, 360, 180, True), (144, 288, 144, True),
         (180, 360, 36, False)]


def main() -> int:
    import torch

    import chip_smoke
    from super_resolution_tpu_torch.ops import cuda_ffn as cf

    if not torch.cuda.is_available():
        print("gated_ffn_variants: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs = build("gated_dconv_ffn.cu", VARIANTS, "mma_gated_dconv_ffn_kernel",
                 {"sr_mma_gated_dconv_ffn": [P] * 10 + [I] * 8 + [F] + [P],
                  "sr_mma_gated_dconv_ffn_smem": [I] * 2})
    for name, (_, usage) in libs.items():
        print(f"{name}: {usage}", flush=True)
    b, hw, dt = 4, 160, torch.bfloat16
    stream = torch.cuda.current_stream().cuda_stream
    for c, m, c_out, block in CASES:
        t = chip_smoke._device_randn(dt, c + m + c_out)
        x = t(b, hw, hw, c)
        norm = (1.0 + t(c, s=0.1), t(c, s=0.1))
        ffn = (t(c, 2 * m, s=c ** -0.5), t(2 * m, s=0.5),
               t(3, 3, 2 * m, s=1 / 3), t(2 * m, s=0.1),
               t(m, c_out, s=m ** -0.5), t(c_out, s=0.1))
        ref = (cf.ffn_block_reference(x, *norm, *ffn) if block
               else cf.ffn_reference(x, *ffn))
        tol = chip_smoke.TOL_BF16 * max(1.0, ref.float().abs().max().item())
        out = torch.empty_like(ref)
        line = f"C {c} M {m} C_out {c_out} {'block' if block else 'bare'}:"
        for name, (lib, _) in libs.items():
            if lib.sr_mma_gated_dconv_ffn_smem(c, c_out) > MAX_DYNAMIC_SMEM:
                line += f" {name} -;"
                continue

            def run(lib=lib, name=name):
                err = lib.sr_mma_gated_dconv_ffn(
                    x.data_ptr(), norm[0].data_ptr(), norm[1].data_ptr(),
                    *(v.data_ptr() for v in ffn), out.data_ptr(), b, hw, hw,
                    c, m, c_out, int(block), int(block), 1e-5, stream)
                if err:
                    raise RuntimeError(f"{name}: cudaError_t {err}")
            run()
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            if name in EXACT and not err <= tol:
                raise AssertionError(f"{name} at C {c}, M {m}, C_out "
                                     f"{c_out}: {err} > {tol}")
            ms = chip_smoke.time_ms(run, reps=20, warmup=3)
            line += f" {name} {ms:.4f};"
        print(line, flush=True)
        del x, norm, ffn, ref, out
    return 0


if __name__ == "__main__":
    sys.exit(main())
