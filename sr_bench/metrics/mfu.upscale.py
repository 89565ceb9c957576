"""The whole forward's share of the card's bf16 peak: the model FLOPs of
every forward of the traced window (the reference's ``flops`` at the
forward shapes of the benchmark's own tile plan) over the window's length
and 989 TFLOP/s."""

from sr_bench.yardstick import PEAK


def read(r):
    if r.timeline is None or not r.forwards:
        return None
    return 100.0 * r.flops() / (r.timeline.window_s * PEAK["bf16"])
