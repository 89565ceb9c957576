"""Time row 8, ``ln_split``, at the fork HAT's chunk shape on the GPU, two
ways: on one input again and again (a 37 MB input mostly stays in the
H100's 50 MB L2 between calls), and on two inputs in turn (each call's
reads come from HBM).

    python3 -m super_resolution_tpu_torch.tools.ln_split_timing

Each way is timed through the wrapper (one call between two CUDA events:
the wrapper's host work, about 20 us, counts where the kernel is shorter)
and through the kernel's C entry, 20 launches between the events on
outputs allocated beforehand (the kernel alone); also one call of the
entry the fork's HAB calls (``ln_split_ad`` where the tree has it, else
``ln_split``) in inference mode, as an evaluation forward runs it. Beside
them:
``F.layer_norm`` (the one PyTorch call for most of the function, timed
the same two ways), the float32 first version through the wrapper, and the
bound (bytes over the HBM rate). Prints the card's name and power limit
and one JSON line. Medians of 10 timings each.

In a tree whose library has no ``sr_ln_split_vec`` (before the bf16
kernel), the bf16 entry timed is ``sr_ln_split``'s, so the script times
two trees alike.
"""

from __future__ import annotations

import json
import statistics
import subprocess

SHAPE = (4, 160, 160, 180)
PDIM = 16
LAUNCHES = 20
HBM = 3.35e12  # bytes a second, H100 SXM


def median_event_ms(fn, reps: int = 10, warmup: int = 2,
                    per: int = 1) -> float:
    """Median of CUDA-event-timed calls of fn, over ``per``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per)
    return statistics.median(times)


def bound_ms(shape=SHAPE, pdim: int = PDIM, esize: int = 2) -> float:
    """x read once, ln1 and x1 written once, gamma and beta read once, over
    the HBM rate (the operations, 8 a value, take less at 67 TFLOP/s)."""
    tok, c = shape[0] * shape[1] * shape[2], shape[3]
    return (2 * tok * c + tok * pdim + 2 * c) * esize / HBM * 1e3


def timing(shape=SHAPE, pdim: int = PDIM, seed: int = 8) -> dict:
    import torch
    import torch.nn.functional as F

    from super_resolution_tpu_torch.ops import cuda_build
    from super_resolution_tpu_torch.ops import cuda_hab as ch

    lib = cuda_build.load_library()
    c = shape[-1]
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*s, dtype=torch.bfloat16):
        return torch.randn(s, generator=gen, device="cuda").to(dtype)

    xs = [randn(*shape), randn(*shape)]
    g, b = 1.0 + 0.1 * randn(c), 0.1 * randn(c)
    outs = [(torch.empty_like(x), torch.empty((*shape[:-1], pdim),
                                              dtype=x.dtype,
                                              device="cuda")) for x in xs]
    n_tok = xs[0].numel() // c
    stream = torch.cuda.current_stream().cuda_stream
    vec = "sr_ln_split_vec" in cuda_build._SIGNATURES

    def entry(i: int):
        ops = (xs[i].data_ptr(), g.data_ptr(), b.data_ptr(),
               outs[i][0].data_ptr(), outs[i][1].data_ptr(), n_tok, c, pdim,
               1e-5, stream)
        err = lib.sr_ln_split_vec(*ops) if vec else lib.sr_ln_split(1, *ops)
        cuda_build.raise_on_error("ln_split", err)

    def loop(turns):
        def run():
            for k in range(LAUNCHES):
                entry(k % turns)
        return run

    def pair(fn):
        def run():
            fn(0)
            fn(1)
        return run

    def wrapper(i):
        ch.ln_split(xs[i], g, b, eps=1e-5, pdim=pdim)

    hab_entry = getattr(ch, "ln_split_ad", ch.ln_split)

    def hab_call():
        with torch.inference_mode():
            hab_entry(xs[0], g, b, eps=1e-5, pdim=pdim)

    def layer_norm(i):
        F.layer_norm(xs[i], (c,), g, b, 1e-5)

    def layer_norm_loop(turns):
        def run():
            for k in range(LAUNCHES):
                layer_norm(k % turns)
        return run

    entry(0)
    torch.cuda.synchronize()
    got = outs[0]
    ref = ch.ln_split_reference(xs[0], g, b, 1e-5, pdim)
    err = max((o.float() - r.float()).abs().max().item()
              for o, r in zip(got, ref))
    x32 = xs[0].float()
    g32, b32 = g.float(), b.float()
    res = dict(
        shape=list(shape), pdim=pdim, max_abs_err=err,
        max_abs_plain=ref[0].float().abs().max().item(),
        x1_bit_equal=bool(torch.equal(got[1], got[0][..., :pdim])),
        wrapper_ms=median_event_ms(lambda: wrapper(0)),
        wrapper_two_buffers_ms=median_event_ms(pair(wrapper), per=2),
        hab_entry=hab_entry.__name__, hab_entry_ms=median_event_ms(hab_call),
        entry_ms=median_event_ms(loop(1), per=LAUNCHES),
        entry_two_buffers_ms=median_event_ms(loop(2), per=LAUNCHES),
        layer_norm_ms=median_event_ms(lambda: layer_norm(0)),
        layer_norm_two_buffers_ms=median_event_ms(pair(layer_norm), per=2),
        layer_norm_loop_ms=median_event_ms(layer_norm_loop(1),
                                           per=LAUNCHES),
        layer_norm_loop_two_buffers_ms=median_event_ms(layer_norm_loop(2),
                                                       per=LAUNCHES),
        float32_wrapper_ms=median_event_ms(
            lambda: ch.ln_split(x32, g32, b32, eps=1e-5, pdim=pdim)),
        bound_ms=bound_ms(shape, pdim), entry="sr_ln_split_vec" if vec
        else "sr_ln_split")
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ln_split_timing: no CUDA device")
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps(timing()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
