"""Time variants of the bf16 kernels of ``hab_front`` (``csrc/hab_front.cu``,
``mma_hab_front_kernel``) and ``fused_scc_block`` (``csrc/scc_block.cu``,
``mma_scc_block_kernel`` and ``mma_scc_reduce_kernel``) on one card: where
their time goes, without ncu, and which tile to keep.

A variant is the source with some text replaced (``mlp_tail_variants``'s
way): a constant changed, or a part knocked out (``no_*``; their outputs
are wrong by design). All variants are compiled at once, each into a
shared library of its own under the package's ``_build/``, and the C entry
of each is timed with CUDA events (median of 20 calls) on seeded bf16
inputs: ``sr_mma_hab_front`` on a chunk of four 160 x 160 tiles at the
fork's C / MID 180 / 60 and HAT-S's 144 / 6; ``sr_mma_scc_block`` on
HiT-SRF's chunk of four 192 x 192 tiles at each window size. The variants
that compute the function are held against the plain version within
``chip_smoke.TOL_BF16`` (the SCC also within ``TOL_SCC_BF16_L2``). Each
line prints a variant's registers and spills (ptxas), then its times.

    python3 -m super_resolution_tpu_torch.tools.front_scc_variants
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

from super_resolution_tpu_torch.tools.mlp_tail_variants import build

_CONV1 = ("          mma::mma_bf16(acc1[i][2 * np], af, bw[np][0], "
          "bw[np][1]);\n          mma::mma_bf16(acc1[i][2 * np + 1], af, "
          "bw[np][2], bw[np][3]);")
_CONV2 = ("          mma::mma_bf16(acc2[i][2 * np], af[i], bw[0], bw[1]);\n"
          "          mma::mma_bf16(acc2[i][2 * np + 1], af[i], bw[2], "
          "bw[3]);")
_LN = ("    if (p < 0) continue;  // warp-uniform\n"
       "    bf16* row = at + t * lst;")
_LOADS = "  auto load = [&](int s) {\n    if (s < kTaps) {"
# name -> [(text, replacement)]
FRONT_VARIANTS = {
    "kernel": [],
    "tile_8x8": [("constexpr int kTileX = 16;", "constexpr int kTileX = 8;")],
    "stages_3": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
    "no_conv1": [(_CONV1, "")],
    "no_conv2": [(_CONV2, "")],
    "no_layernorm": [(_LN, "    if (p >= 0) continue;\n"
                           "    bf16* row = at + t * lst;")],
    "no_weight_copies": [(_LOADS, "  auto load = [&](int s) {\n"
                                  "    if (s < 0) {")],
}
FRONT_EXACT = ("kernel", "tile_8x8", "stages_3")

_BIAS = ("          if (a.vec_bias && m + 1 < bl) {\n"
         "            bv[jn][hh] = __ldg(reinterpret_cast<const float2*>("
         "br));\n"
         "          } else {\n"
         "            if (m < bl) bv[jn][hh].x = __ldg(br);\n"
         "            if (m + 1 < bl) bv[jn][hh].y = __ldg(br + 1);\n"
         "          }")
_HEADS = "    for (int h = 0; h < heads; ++h) {\n      const int h0 = h * d"
SCC_VARIANTS = {
    "kernel": [],
    "two_blocks_an_sm": [("constexpr int kMinBlocks = 3;",
                          "constexpr int kMinBlocks = 2;")],
    "no_bias": [(_BIAS, "")],
    "no_heads": [(_HEADS, "    for (int h = 0; h < 0; ++h) {\n"
                          "      const int h0 = h * d")],
}
SCC_EXACT = ("kernel", "two_blocks_an_sm")
FRONT_CASES = [(180, 60), (144, 6)]


def _card() -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)


def time_front(libs: dict) -> None:
    import torch

    import chip_smoke
    from super_resolution_tpu_torch.ops import cuda_hab as ch

    b, hw, dt, pdim = 4, 160, torch.bfloat16, chip_smoke.PDIM
    stream = torch.cuda.current_stream().cuda_stream
    for c, mid in FRONT_CASES:
        t = chip_smoke._device_randn(dt, c + mid)
        x = t(b, hw, hw, c)
        front = (1.0 + t(c, s=0.1), t(c, s=0.1),
                 t(3, 3, c, mid, s=(9 * c) ** -0.5), t(mid, s=0.1),
                 t(3, 3, mid, c, s=(9 * mid) ** -0.5), t(c, s=0.1))
        ref = ch.hab_front_reference(x, *front, 1e-5, pdim)
        outs = (torch.empty_like(x), torch.empty_like(x),
                torch.empty((b, c), dtype=torch.float32, device="cuda"),
                torch.empty((b, pdim), dtype=torch.float32, device="cuda"))
        # room for the partial sums of 8 x 8 tiles, the smallest variant's
        partial = torch.empty(b * (hw // 8) ** 2 * (c + pdim),
                              dtype=torch.float32, device="cuda")
        line = f"hab_front C {c} MID {mid}:"
        for name, (lib, _) in libs.items():
            def run(lib=lib, name=name):
                err = lib.sr_mma_hab_front(
                    x.data_ptr(), *(v.data_ptr() for v in front),
                    outs[0].data_ptr(), outs[1].data_ptr(),
                    partial.data_ptr(), outs[2].data_ptr(),
                    outs[3].data_ptr(), b, hw, hw, c, mid, pdim, 1e-5,
                    stream)
                if err:
                    raise RuntimeError(f"{name}: cudaError_t {err}")
            run()
            torch.cuda.synchronize()
            if name in FRONT_EXACT:
                err, ok = chip_smoke.max_err_and_tol(outs[:2], ref[:2],
                                                     chip_smoke.TOL_BF16)
                rel = chip_smoke.front_sums_rel_err(outs, ref)
                if not (ok and rel <= chip_smoke.TOL_BF16):
                    raise AssertionError(f"{name} at C {c}, MID {mid}: "
                                         f"{err}, sums {rel}")
            ms = chip_smoke.time_ms(run, reps=20, warmup=3)
            line += f" {name} {ms:.4f};"
        print(line, flush=True)
        del x, front, ref, outs, partial


def time_scc(libs: dict) -> None:
    import torch

    import chip_smoke
    from super_resolution_tpu_torch.ops import cuda_scc as cs

    b, h, w, c, heads, bs = chip_smoke.SCC_SHAPE
    stream = torch.cuda.current_stream().cuda_stream
    for ws in chip_smoke.SCC_WINDOWS:
        win, base = (ws, ws), (min(ws, bs),) * 2
        args = chip_smoke.scc_inputs(torch.bfloat16, 2 * ws,
                                     (b, h, w, c, heads), win, base)
        ref = cs.scc_block_reference(*args, heads, win, base)
        exact = cs.scc_block_reference(*(a.float() for a in args), heads,
                                       win, base)
        out = torch.empty_like(ref)
        n_win = b * (h // ws) * (w // ws)
        line = f"fused_scc_block window {ws}:"
        for name, (lib, _) in libs.items():
            scratch = torch.empty(
                max(1, n_win * lib.sr_mma_scc_block_scratch(
                    ws, ws, *base, c, heads)),
                dtype=torch.float32, device="cuda")

            def run(lib=lib, name=name, scratch=scratch):
                err = lib.sr_mma_scc_block(
                    *(a.data_ptr() for a in args), scratch.data_ptr(),
                    out.data_ptr(), b, h, w, c, heads, ws, ws, *base, stream)
                if err:
                    raise RuntimeError(f"{name}: cudaError_t {err}")
            run()
            torch.cuda.synchronize()
            if name in SCC_EXACT:
                err, ok = chip_smoke.max_err_and_tol(out, ref,
                                                     chip_smoke.TOL_BF16)
                l2 = ((out.float() - exact).norm() / exact.norm()).item()
                if not (ok and l2 <= chip_smoke.TOL_SCC_BF16_L2):
                    raise AssertionError(f"{name} at window {ws}: {err}, "
                                         f"rel L2 {l2}")
            ms = chip_smoke.time_ms(run, reps=20, warmup=3)
            line += f" {name} {ms:.4f};"
            del scratch
        print(line, flush=True)
        del args, ref, exact, out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("front_scc_variants: no CUDA device", file=sys.stderr)
        return 2
    _card()
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    front = build("hab_front.cu", FRONT_VARIANTS, "mma_hab_front_kernel",
                  {"sr_mma_hab_front": [P] * 12 + [I] * 6 + [F] + [P],
                   "sr_mma_hab_front_smem": [I] * 2})
    scc = build("scc_block.cu", SCC_VARIANTS, "mma_scc_block_kernel",
                {"sr_mma_scc_block": [P] * 8 + [I] * 9 + [P],
                 "sr_mma_scc_block_scratch": [I] * 6})
    for name, (_, usage) in {**{f"front {k}": v for k, v in front.items()},
                             **{f"scc {k}": v for k, v in scc.items()}
                             }.items():
        print(f"{name}: {usage}", flush=True)
    time_front(front)
    time_scc(scc)
    return 0


if __name__ == "__main__":
    sys.exit(main())
