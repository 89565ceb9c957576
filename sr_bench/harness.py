"""One run of one cell: set-up, the measured window, the readings and the
check against the plain reference.

The cell's mix names its driver (``drivers/<driver>.py``), whose ``Run``
does the work of the kind of traffic: its constructor is the set-up
(building the program, loading the benchmark's seeded weights, warming up
every shape the mix sends), ``window(seconds)`` drives the program for the
measured window, which it marks with ``trace.WINDOW_SPAN`` and times by its
own clock, and returns a :class:`Reading`; ``free()`` lets go of the
program, and ``check(reading)`` returns each number compared with the
reference (``limits/<cell>.json`` holds its limit). Here: the clock of the
set-up, the profiler around the window with ``trace``, the device's peak
memory read before the program is freed, each metric's reader, and the
result object.
"""

from __future__ import annotations

import contextlib
import gc
import time
from dataclasses import dataclass, field

import torch

from sr_bench import spec
from sr_bench.trace import Timeline, Tracer


@dataclass
class Reading:
    """What a driver's window gives and the metric readers read
    (``metrics/<metric>.py``): ``requests`` and ``forwards`` (the (b, h, w)
    of every forward the window's work asks of the network) where the
    driver has them."""

    cell: spec.Cell
    window_s: float
    attempted: int
    failed: int
    requests: list = field(default_factory=list)
    forwards: list = field(default_factory=list)
    setup_s: float = 0.0
    timeline: Timeline | None = None

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def mix(self) -> dict:
        return self.cell.mix

    @property
    def net(self) -> dict:
        return self.config["network_g"]

    def flops(self) -> int:
        """Model FLOPs of every forward of the window, by the reference's
        counter."""
        count = reference_module(self.config, self.cell.root).flops
        return sum(count(self.net, *f) for f in self.forwards)


def reference_module(config: dict, root=spec.REPO_ROOT):
    return spec.load("reference", config["reference"], root)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def device_info(device, chips: int) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float, fault=None) -> dict:
    """One run; returns the result object (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, ``breakdown`` where traced,
    ``checks``). ``fault(program)``, where given, breaks the program after
    its set-up (the tests' faults)."""
    driver = spec.load("drivers", cell.mix["driver"], cell.root)
    run = driver.Run(cell, seed, device)
    sync(device)
    setup_s = time.perf_counter() - t_start
    if fault is not None:
        fault(run.program)

    tracer = Tracer() if trace else contextlib.nullcontext()
    with tracer:
        reading = run.window(seconds)
    reading.setup_s = setup_s
    reading.timeline = tracer.timeline() if trace else None
    dev = device_info(device, cell.chips)
    run.free()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(m["name"], cell.root)(reading)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # a limit whose number the driver did not give fails
    numbers = run.check(reading)
    checks = {k: {"value": numbers.get(k, float("inf")),
                  "limit": lim["limit"]} for k, lim in cell.limits.items()}
    correct = reading.failed == 0 and all(c["value"] <= c["limit"]
                                          for c in checks.values())
    result = {"correct": correct, "attempted": reading.attempted,
              "failed": reading.failed, "metrics": metrics, "device": dev}
    if reading.timeline is not None:
        dev["busy_s"] = reading.timeline.busy_s
        dev["window_s"] = reading.timeline.window_s
        result["breakdown"] = reading.timeline.breakdown()
    result["checks"] = checks
    return result
