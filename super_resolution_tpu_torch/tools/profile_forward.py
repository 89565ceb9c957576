"""Profile one chunk forward of a network at its published width on the
GPU by device-op class, with the device's idle share and the peak device
memory.

The network, tile settings and weights are those of ``chip_smoke.py``'s
main paths (``classic``: HATClassic x4; ``fork``: the fork's HAT x2 with
the ESC-infused OCAB; ``esc``: ESC x4; ``esc_xl``: ESC-XL x4; ``atd``: ATD
x4; ``srformer``: SRFormer x4; ``hitsrf``: HiT-SRF x4; ``classic_hab_block``:
HATClassic x4 on its whole-block route; any other label of its ``PATHS``,
see :func:`labels`), so run it from the repository root, where that script
lies:

    python3 -m super_resolution_tpu_torch.tools.profile_forward atd

It prints the card's name and power limit, the median wall time of five
forwards without the profiler, then from three profiled forwards the mean
per forward of: wall time, device time by class (each of the port's CUDA
kernels by name with its shortest and longest launch, cuDNN/CUTLASS
convolutions, matrix products, the rest) and the 15 device ops that take
most time; and, for the fork path, CUDA-event times of the parts
of one HAB front that run outside the port's kernels: the large-kernel
conv on the ESC slab, the per-sample dynamic depthwise conv and the CAB.

    python3 -m super_resolution_tpu_torch.tools.profile_forward --ab \
        fork fork_hab_front fork_hab_front fork

times the chunk forwards of several paths in turn in one process, on one
card (median of five each, after two warm-up forwards): an A/B of two
routes.

    python3 -m super_resolution_tpu_torch.tools.profile_forward --kernel \
        fused_ocab_block fused_msa_attention

times each named kernel wrapper on ``chip_smoke.py``'s bf16 inputs at its
main path's chunk shape (the image-attention kernels at both of their
shapes, with and without the shift mask): the CUDA-event median of 20 calls
and, under the profiler, the mean device time of each kernel a call
launches (a wrapper may launch several).
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time

PROFILED_FORWARDS = 3

# a tensor-core kernel's name holds its FMA partner's: it is matched first
PORT_KERNELS = ("msa_block_kernel", "ocab_block_kernel",
                "mma_ocab_attention_kernel", "ocab_attention_kernel",
                "mma_mlp_tail_kernel", "mlp_tail_kernel",
                "mma_hab_tail_kernel", "mma_gated_dconv_ffn_kernel",
                "gated_dconv_ffn_kernel", "ln_split_vec_kernel",
                "ln_split_kernel",
                "fused_attention_kernel", "fused_attention_v3_kernel",
                "mma_window_attention_kernel",
                "mma_window_attention_v3_kernel", "msa_flash_kernel",
                "mma_flash_attention_kernel", "msa_qtile_kernel",
                "mma_qtile_attention_kernel",
                "mma_msa_attention_kernel", "msa_attention_kernel",
                "mma_ln_proj_kernel", "mma_proj_residual_kernel",
                "mma_proj_bias_kernel",
                "mma_psa_block_kernel",
                "psa_block_kernel",
                "mma_scc_block_kernel", "mma_scc_reduce_kernel",
                "scc_block_kernel", "scc_reduce_kernel", "hab_block_kernel",
                "mma_hab_front_kernel", "hab_front_kernel",
                "hab_front_sum_kernel")


def labels() -> list:
    """The paths this script profiles: the labels of ``chip_smoke.PATHS``."""
    import chip_smoke

    return list(chip_smoke.PATHS)


def classify(name: str) -> str:
    low = name.lower()
    for kernel in PORT_KERNELS:
        if kernel in low:
            return kernel
    if any(k in low for k in ("conv", "cudnn", "wgrad", "dgrad", "implicit",
                              "xmma", "fprop", "nchwtonhwc", "nhwctonchw")):
        return "convolutions (cuDNN/CUTLASS, with their layout copies)"
    if any(k in low for k in ("gemm", "cutlass", "cublas", "gemv", "nvjet")):
        return "matrix products (cuBLAS)"
    if "memcpy" in low or "memset" in low:
        return "memcpy / memset"
    return "other (elementwise, reductions, copies)"


def on_device(ev) -> bool:
    """A row of a device op (the CPU-side rows repeat their kernels' time)."""
    return "cuda" in str(getattr(ev, "device_type", "cuda")).lower()


def device_us(ev) -> float:
    """Self device time of a profiler row, under either name torch gives
    it."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(ev, attr):
            return getattr(ev, attr) or 0
    return 0


def _setup(names) -> bool:
    """Check the labels and the card; print the card's name and power
    limit."""
    import torch

    unknown = [n for n in names if n not in labels()]
    if unknown:
        print(f"profile_forward: unknown path {unknown}; one of {labels()}",
              file=sys.stderr)
        return False
    if not torch.cuda.is_available():
        print("profile_forward: no CUDA device", file=sys.stderr)
        return False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return True


def chunk_forward(label: str):
    """(predictor, forward, chunk input, ms of one forward) of a path at
    its first run's tile plan, seeded weights, bf16."""
    import torch

    import chip_smoke

    pred = chip_smoke.make_predictor(label, "cuda", bf16=True)
    fwd = pred.model._apply_fn()
    plan = chip_smoke.PATHS[label]["runs"][0][0]
    tile = plan["tile_size"] + 2 * plan["tile_pad"]
    x = torch.rand((plan["chunk"], tile, tile, 3), device="cuda",
                   generator=torch.Generator("cuda").manual_seed(0))

    def forward_ms():
        t0 = time.perf_counter()
        fwd(x)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3
    return pred, fwd, x, forward_ms


def median_ms(forward_ms) -> float:
    """Median of five forwards after two warm-up ones."""
    for _ in range(2):
        forward_ms()
    return statistics.median(forward_ms() for _ in range(5))


def ab(names) -> int:
    """Chunk forwards of ``names`` in turn, in one process."""
    import torch

    if not _setup(names):
        return 2
    runs = {}
    with torch.inference_mode():
        for name in dict.fromkeys(names):
            runs[name] = chunk_forward(name)[3]
        for name in names:
            print(f"path {name}: one chunk forward {median_ms(runs[name]):.1f}"
                  f" ms (median of 5)", flush=True)
    return 0


def kernel_calls(name: str) -> dict:
    """label -> call of the wrapper ``name`` on chip_smoke's bf16 inputs at
    its main path's chunk shape."""
    import torch

    import chip_smoke

    fn = chip_smoke.wrappers()[name]
    image = {"fused_msa_attention": (chip_smoke.msa_attention_cases,
                                     chip_smoke.MSA_SHAPES),
             "fused_psa_block": (chip_smoke.psa_block_cases,
                                 chip_smoke.PSA_SHAPES)}
    if name not in image:
        args, kw, _, _ = chip_smoke.kernel_cases(4, 160, torch.bfloat16,
                                                 seed=164)[name]
        return {name: lambda: fn(*args, **kw)}
    cases_of, shapes = image[name]
    calls = {}
    for i, shape in enumerate(shapes):
        for label, (_, args, kw, *_) in cases_of(torch.bfloat16, 7 + i,
                                                  shape).items():
            calls[f"{label} {shape}"] = (
                lambda args=args, kw=kw: fn(*args, **kw))
    return calls


def kernels(names) -> int:
    """CUDA-event ms of each wrapper call and the device time of each
    kernel it launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import time_ms

    if not _setup([]):
        return 2
    with torch.inference_mode():
        for name in names:
            for label, call in kernel_calls(name).items():
                ms = time_ms(call, reps=20)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(10):
                        call()
                    torch.cuda.synchronize()
                parts = [f"{classify(ev.key)} {device_us(ev) / ev.count:.1f}"
                         for ev in prof.key_averages()
                         if device_us(ev) > 0 and on_device(ev)]
                print(f"{label}: {ms:.3f} ms (median of 20); a launch, us: "
                      f"{'; '.join(parts)}", flush=True)
    return 0


def main(label: str) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not _setup([label]):
        return 2
    pred, fwd, x, forward_ms = chunk_forward(label)
    tile = x.shape[1]
    with torch.inference_mode():
        plain_ms = median_ms(forward_ms)
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall_ms = statistics.fmean(forward_ms()
                                       for _ in range(PROFILED_FORWARDS))
    peak_mb = torch.cuda.max_memory_allocated() / 1e6

    per = 1.0 / PROFILED_FORWARDS
    classes: dict = {}
    for ev in prof.key_averages():
        us = device_us(ev)
        if us <= 0 or not on_device(ev):
            continue
        ms, n = classes.get(classify(ev.key), (0.0, 0))
        classes[classify(ev.key)] = (ms + us / 1e3 * per, n + ev.count * per)
    # shortest and longest single launch of each of the port's kernels
    spread: dict = {}
    for ev in prof.events():
        us = device_us(ev)
        if us > 0 and on_device(ev) and classify(ev.name) in PORT_KERNELS:
            lo, hi = spread.get(classify(ev.name), (us, us))
            spread[classify(ev.name)] = (min(lo, us), max(hi, us))
    busy = sum(ms for ms, _ in classes.values())
    if busy <= 0:
        print("profile_forward: the profiler saw no device time",
              file=sys.stderr)
        return 1
    print(f"path {label}: one chunk forward of {tuple(x.shape)} bf16: "
          f"{plain_ms:.1f} ms without the profiler (median of 5); under it "
          f"(mean of {PROFILED_FORWARDS}) wall {wall_ms:.1f} ms, device busy "
          f"{busy:.1f} ms, idle share "
          f"{max(0.0, 1 - busy / wall_ms) * 100:.2f}%, peak device memory "
          f"{peak_mb:.1f} MB")
    print("| class | device ops | device ms | share of busy | "
          "a launch, ms |")
    print("|---|---|---|---|---|")
    for name, (ms, n) in sorted(classes.items(), key=lambda kv: -kv[1][0]):
        lo_hi = (f"{spread[name][0] / 1e3:.3f} to {spread[name][1] / 1e3:.3f}"
                 if name in spread else "")
        print(f"| {name} | {n:.0f} | {ms:.3f} | {ms / busy * 100:.1f}% | "
              f"{lo_hi} |")
    rows = sorted((ev for ev in prof.key_averages()
                   if device_us(ev) > 0 and on_device(ev)),
                  key=lambda ev: -device_us(ev))[:15]
    print("top device ops by name:")
    for ev in rows:
        print(f"  {device_us(ev) / 1e3 * per:10.3f} ms  "
              f"x{ev.count * per:5.0f}  {ev.key[:110]}")
    if label == "fork":
        hab_parts(pred.model.eval_net(), x.shape[0], tile)
    return 0


def hab_parts(net, b: int, hw: int) -> None:
    """CUDA-event ms of the cuDNN parts of the first HAB's front at the
    chunk's shape, each alone."""
    import torch

    from chip_smoke import time_ms
    from super_resolution_tpu_torch.ops.conv import (
        conv2d_nhwc, dynamic_depthwise_conv3x3)

    blk = net.layers[0].residual_group.blocks[0]
    dt = blk.norm1.weight.dtype
    gen = torch.Generator("cuda").manual_seed(1)
    ln1 = torch.randn((b, hw, hw, blk.norm1.weight.numel()), device="cuda",
                      generator=gen).to(dt)
    x1 = ln1[..., :blk.esc_pdim].contiguous()
    dk = torch.randn((b, 3, 3, blk.esc_pdim), device="cuda",
                     generator=gen).to(dt)
    lk = blk.esc_attn.plk_filter
    with torch.inference_mode():
        parts = {
            f"large-kernel conv {tuple(lk.shape)} on the slab":
                lambda: conv2d_nhwc(x1, lk),
            "per-sample dynamic depthwise 3x3 conv on the slab":
                lambda: dynamic_depthwise_conv3x3(x1, dk),
            "ESC conv attention (GAP, head, both convs, aggregation)":
                lambda: blk.esc_attn(ln1, x1),
            "CAB (3x3, GELU, 3x3, ECA)": lambda: blk.conv_block(ln1),
        }
        print(f"parts of one HAB front at {tuple(ln1.shape)} {dt}, "
              f"CUDA-event median ms:")
        for name, fn in parts.items():
            print(f"  {time_ms(fn):8.3f} ms  {name}")


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--ab":
        sys.exit(ab(sys.argv[2:]))
    if len(sys.argv) > 1 and sys.argv[1] == "--kernel":
        sys.exit(kernels(sys.argv[2:]))
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "fork"))
