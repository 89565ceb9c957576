"""Profile real-world GAN training iterations on the GPU by device-op
class.

It runs one of ``chip_smoke.py``'s phase-8 files (``real_hat_mse``,
``real_hat_gan``, ``esc_real_mse``, ``esc_real_gan``) at its published
network and batch on seeded random weights (VGG19's too) and a synthetic
loader batch of the real-world dataset's form, from the repository root:

    python3 -m super_resolution_tpu_torch.tools.profile_real_step real_hat_gan

It prints the card's name and power limit; the median of five iterations
without the profiler, float32 with TF32 off (as ``chip_smoke.py``) and
with cuDNN's TF32 on (PyTorch's default for convolutions); then, from two
profiled iterations (TF32 off), the mean per iteration of the wall time,
the device time of each device-op class and of the ops that take most,
and the idle share, and the device time of the FFT-based convolutions
(cuDNN's complex GEMMs and FFTs). ``chip_smoke.py`` phase 8 splits an iteration into
the synthesizer's, G's and D's steps.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time

PROFILED = 2


def _runner(label: str, root: str):
    import torch

    import chip_smoke
    from super_resolution_tpu_torch.models.vgg_arch import \
        seeded_vgg19_state_dict
    from super_resolution_tpu_torch.runtime import build_model
    from super_resolution_tpu_torch.utils.options import yaml_load

    opt = yaml_load(chip_smoke.REAL_TRAIN_PATHS[label]["yml"])
    vgg = f"{root}/vgg19.pth"
    torch.save(seeded_vgg19_state_dict(0), vgg)
    batch = opt["datasets"]["train"]["batch_size_per_gpu"]
    opt.update(is_train=True, queue_size=2 * batch,
               path={"pretrain_network_g": None})
    opt.setdefault("gt_size", opt["datasets"]["train"]["gt_size"])
    if opt["train"].get("perceptual_opt"):
        opt["train"]["perceptual_opt"]["vgg_weights_path"] = vgg
    model = build_model(opt, "cuda")
    model.setup_training()
    return model, chip_smoke._synth_batch(batch, seed=0), batch


def main(label: str) -> int:
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from super_resolution_tpu_torch.tools.profile_forward import (
        classify, device_us, on_device)

    if not torch.cuda.is_available():
        print("profile_real_step: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as root:
        model, batch, b = _runner(label, root)
        it = [0]

        def iteration():
            it[0] += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.optimize_parameters(batch, it[0])
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t0)

        medians = {}
        for tf32 in (False, True):
            torch.backends.cudnn.allow_tf32 = tf32
            iteration(), iteration()
            medians[tf32] = statistics.median(iteration() for _ in range(5))
        torch.backends.cudnn.allow_tf32 = False
        iteration()

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = statistics.fmean(iteration() for _ in range(PROFILED))

    per = 1.0 / PROFILED
    classes: dict = {}
    for ev in prof.key_averages():
        us = device_us(ev)
        if us <= 0 or not on_device(ev):
            continue
        ms, n = classes.get(classify(ev.key), (0.0, 0))
        classes[classify(ev.key)] = (ms + us / 1e3 * per, n + ev.count * per)
    busy = sum(ms for ms, _ in classes.values())
    if busy <= 0:
        print("profile_real_step: the profiler saw no device time",
              file=sys.stderr)
        return 1
    print(f"{label}: {type(model).__name__} at batch {b}: an iteration "
          f"{medians[False]:.1f} ms float32 with TF32 off, "
          f"{medians[True]:.1f} ms with cuDNN's TF32 (medians of 5); under "
          f"the profiler (mean of {PROFILED}, TF32 off) wall {wall:.1f} ms, "
          f"device busy {busy:.1f} ms, idle share "
          f"{max(0.0, 1 - busy / wall) * 100:.2f}%")
    fft = sum(device_us(ev) for ev in prof.key_averages()
              if on_device(ev) and ("cf32" in ev.key
                                    or "fft" in ev.key.lower()))
    print(f"of which FFT-based convolutions (complex GEMMs, FFTs): "
          f"{fft / 1e3 * per:.1f} ms")
    print("| class | device ops | device ms | share of busy |")
    print("|---|---|---|---|")
    for name, (ms, n) in sorted(classes.items(), key=lambda kv: -kv[1][0]):
        print(f"| {name} | {n:.0f} | {ms:.3f} | {ms / busy * 100:.1f}% |")
    rows = sorted((ev for ev in prof.key_averages()
                   if device_us(ev) > 0 and on_device(ev)),
                  key=lambda ev: -device_us(ev))[:12]
    print("top device ops by name:")
    for ev in rows:
        print(f"  {device_us(ev) / 1e3 * per:10.3f} ms  "
              f"x{ev.count * per:5.0f}  {ev.key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "real_hat_gan"))
