"""The traced run's device timeline, from ``torch.profiler``.

``Tracer`` profiles the CPU and the card over the measured window; the
window itself is the harness's ``sr_bench.window`` span. ``Timeline``
reduces the profiler's events to what the per-layer readers and the
result's ``breakdown`` need: the window's length, the union of device
activity (busy seconds), each device op's time and launches by name, and
the idle gaps, each put to the host activity under its midpoint (the
innermost CPU event of the window's thread that covers it).

The list of the program's kernels is a copy of
``super_resolution_tpu_torch/tools/profile_forward.py``'s ``PORT_KERNELS``.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

WINDOW_SPAN = "sr_bench.window"
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
# gaps shorter than this are launch spacing, not idling worth naming
MIN_GAP_NS = 5_000
# how far back from a gap the innermost covering host event is sought
HOST_LOOKBACK = 4096


def is_port_kernel(name: str) -> bool:
    low = name.lower()
    return any(kernel in low for kernel in PORT_KERNELS)


def _is_annotation(ev) -> bool:
    """Whether a profiler event is a span, not an op (the attribute that
    tells differs between torch versions)."""
    kind = getattr(ev, "activity_type", None)
    if kind is not None:
        return "annotation" in str(kind())
    flag = getattr(ev, "is_user_annotation", None)
    return bool(flag()) if flag is not None else False


class Tracer:
    """``torch.profiler`` over the CPU and the card, started and stopped by
    the harness around its window."""

    def __init__(self):
        self.prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        return False

    def timeline(self) -> "Timeline":
        rows = []
        for ev in self.prof.profiler.kineto_results.events():
            dev = "cuda" in str(ev.device_type()).lower()
            if dev and (ev.name().startswith("sr_bench.")
                        or _is_annotation(ev)):
                continue      # a host span's mirror on the device
            rows.append((ev.name(), dev, ev.start_ns(),
                         ev.start_ns() + ev.duration_ns(),
                         ev.start_thread_id()))
        return Timeline(rows)


class Timeline:
    """rows: (name, on_device, start_ns, end_ns, thread) of every event."""

    def __init__(self, rows):
        spans = [r for r in rows if r[0] == WINDOW_SPAN and not r[1]]
        if len(spans) != 1:
            raise ValueError(f"the trace holds {len(spans)} "
                             f"{WINDOW_SPAN!r} spans, not one")
        _, _, self.t0, self.t1, thread = spans[0]
        dev = sorted((max(s, self.t0), min(e, self.t1), n)
                     for n, d, s, e, _ in rows
                     if d and e > self.t0 and s < self.t1)
        self.by_name = defaultdict(lambda: [0.0, 0])
        for s, e, n in dev:
            self.by_name[n][0] += (e - s) * 1e-9
            self.by_name[n][1] += 1
        host = sorted((s, e, n) for n, d, s, e, t in rows
                      if not d and t == thread and n != WINDOW_SPAN)
        self._host_starts = [h[0] for h in host]
        self._host = host
        self.busy_ns = 0
        self.gaps = []
        cursor = self.t0
        for s, e, _ in dev:
            if s > cursor:
                self._gap(cursor, s)
            if e > cursor:
                self.busy_ns += e - max(s, cursor)
                cursor = e
        if self.t1 > cursor:
            self._gap(cursor, self.t1)

    def _gap(self, s: int, e: int) -> None:
        if e - s >= MIN_GAP_NS:
            self.gaps.append(((e - s) * 1e-9, self.host_at((s + e) // 2)))

    def host_at(self, t: int) -> str:
        """The innermost host event of the window's thread covering t."""
        i = bisect.bisect_right(self._host_starts, t) - 1
        for j in range(i, max(i - HOST_LOOKBACK, -1), -1):
            if self._host[j][1] >= t:
                return self._host[j][2]
        return WINDOW_SPAN

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    @property
    def busy_s(self) -> float:
        return self.busy_ns * 1e-9

    def device_s(self, pred=lambda name: True) -> float:
        """Device seconds of the ops whose name satisfies ``pred``."""
        return sum(t for n, (t, _) in self.by_name.items() if pred(n))

    def launches(self, pred) -> int:
        return sum(c for n, (_, c) in self.by_name.items() if pred(n))

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time and the idle gaps by what the
        host was doing, each [name, seconds]."""
        ops = sorted(((n, t) for n, (t, _) in self.by_name.items()),
                     key=lambda x: -x[1])[:top]
        by_host = defaultdict(float)
        for sec, name in self.gaps:
            by_host[name] += sec
        gaps = sorted(by_host.items(), key=lambda x: -x[1])[:top]
        return {"device_ops": [[n[:160], t] for n, t in ops],
                "idle_gaps": [[n[:160], t] for n, t in gaps]}
