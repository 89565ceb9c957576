"""The driver of serving mixes: a closed loop of one caller through the
port's serving entry, ``Predictor.predict_array``.

Set-up builds the ``Predictor`` from the configuration and the mix's tile
plan, loads the benchmark's seeded weights into it as a strict checkpoint
load, and serves one input of every shape the mix sends, twice. In the
window each request's input is made on the host, then ``predict_array``
upscales it and returns it to the host; the next request goes when the
last returns, until ``seconds`` have passed.

The check runs once the window has closed, the memory peak has been read
and the program is freed: a sample of the finished requests drawn from the
seed, the largest among them, is upscaled again by the plain float32
reference (``sr_bench/reference``, TF32 off) through its own pad, tile plan
and crop, from the same inputs and the same seeded weights; each number
compared is the worst over the sample. ``readings`` gives the numbers that
the limits are set from (``python3 -m sr_bench.calibrate``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from sr_bench.harness import Reading, no_tf32, reference_module
from sr_bench.reference.common import Precision
from sr_bench.reference.tile import forward_shapes, upscale
from sr_bench.trace import WINDOW_SPAN
from sr_bench.traffic import Traffic
from sr_bench.weights import seeded_params

# the stream of the check's sample, apart from the requests'
CHECK_STREAM = 2 ** 41
# tiles a call of the reference: what fits beside its float32 scores
REFERENCE_BLOCK = 4


@dataclass
class Request:
    index: int
    lr: tuple
    latency_s: float
    out: np.ndarray


def program_options(config: dict, mix: dict) -> dict:
    opt = dict(name="sr_bench", model_type=config["model_type"],
               scale=config["scale"], manual_seed=0,
               network_g=dict(config["network_g"]),
               val=dict(config.get("val", {})))
    if mix.get("tile"):
        opt["tile"] = dict(mix["tile"])
    return opt


def build_program(config: dict, mix: dict, params: dict, device):
    """The port's Predictor with ``params`` loaded, every name and shape
    matched."""
    from super_resolution_tpu_torch.predict import Predictor

    pred = Predictor(program_options(config, mix), device=device)
    own = dict(pred.model.net_g.named_parameters())
    bad = sorted(set(own) ^ set(params)) + sorted(
        n for n in own if n in params
        and tuple(own[n].shape) != tuple(params[n].shape))
    if bad:
        raise RuntimeError(f"the program's parameters differ from the "
                           f"configuration's: {bad[:8]}")
    load_params(pred, params)
    return pred


def load_params(pred, params: dict) -> None:
    """Copy ``params`` into the Predictor's network; its inference copy is
    made again from them at the next request."""
    with torch.no_grad():
        for name, p in pred.model.net_g.named_parameters():
            p.copy_(params[name])
    pred.model._eval_net = None


class Run:
    def __init__(self, cell, seed: int, device):
        mix = cell.mix
        if mix.get("loop", "closed") != "closed" or mix.get("callers", 1) != 1:
            raise NotImplementedError("this driver serves a closed loop of "
                                      "one caller")
        self.cell, self.seed, self.device = cell, seed, device
        self.traffic = Traffic(mix, seed)
        ref = reference_module(cell.config, cell.root)
        params = seeded_params(ref.param_shapes(cell.config["network_g"]),
                               seed, device)
        self.program = build_program(cell.config, mix, params, device)
        del params
        for _ in range(2):
            for lq in self.traffic.warm_inputs():
                self.program.predict_array(lq)

    def window(self, seconds: float) -> Reading:
        from torch.profiler import record_function

        done = []
        with record_function(WINDOW_SPAN):
            t0 = time.perf_counter()
            i = 0
            while i == 0 or time.perf_counter() - t0 < seconds:
                with record_function("sr_bench.input"):
                    lq = self.traffic.image(i)
                s = time.perf_counter()
                with record_function("sr_bench.request"):
                    out = self.program.predict_array(lq)
                done.append(Request(i, lq.shape[:2],
                                    time.perf_counter() - s, out))
                i += 1
            window_s = time.perf_counter() - t0
        # outside the window: the outputs' check reads gigabytes
        scale = self.cell.config["scale"]
        ws = self.cell.config["network_g"]["window_size"]
        failed = sum(r.out.shape != (r.lr[0] * scale, r.lr[1] * scale, 3)
                     or not np.isfinite(r.out).all() for r in done)
        forwards = [f for r in done
                    for f in forward_shapes(*r.lr, ws, self.traffic.tile)]
        return Reading(self.cell, window_s, len(done), failed, done,
                       forwards)

    def free(self) -> None:
        self.program = None

    def check(self, reading: Reading) -> dict:
        picked = sample(reading.requests, self.cell.mix["check"]["requests"],
                        self.seed)
        return compare(self.cell, self.traffic, picked, self.seed,
                       self.device)


def sample(requests: list, n: int, seed: int) -> list:
    """n finished requests drawn from the seed, the first of the largest
    output among them."""
    largest = max(range(len(requests)),
                  key=lambda k: (requests[k].out.size, -k))
    rest = [k for k in range(len(requests)) if k != largest]
    rng = np.random.default_rng([seed % (2 ** 63), CHECK_STREAM])
    picks = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [requests[largest]] + [requests[rest[k]] for k in sorted(picks)]


def reference_outputs(cell, traffic: Traffic, indices: list, seed: int,
                      device, precision: str = "float32"):
    """The reference's upscale of each request in ``indices`` (a
    generator of (index, output))."""
    ref = reference_module(cell.config, cell.root)
    net = cell.config["network_g"]
    params = seeded_params(ref.param_shapes(net), seed, device)
    p = Precision(precision)

    def forward(x):
        return ref.forward(params, net, x, p)
    with torch.no_grad(), no_tf32():
        for i in indices:
            lq = torch.from_numpy(traffic.image(i)).to(device)
            yield i, upscale(forward, lq, cell.config["scale"],
                             net["window_size"], traffic.tile,
                             REFERENCE_BLOCK)


def errors(out, ref: torch.Tensor) -> dict:
    """rel_rms and rel_max: the RMS and the largest of |out - ref|, each
    over the reference's standard deviation; inf for an output of another
    shape or with a value that is not finite."""
    o = torch.as_tensor(out).to(ref.device)
    if o.shape != ref.shape or not bool(torch.isfinite(o).all()):
        return {"rel_rms": float("inf"), "rel_max": float("inf")}
    d = (o.float() - ref).abs()
    std = ref.std()
    return {"rel_rms": float(d.pow(2).mean().sqrt() / std),
            "rel_max": float(d.max() / std)}


def compare(cell, traffic: Traffic, picked: list, seed: int, device) -> dict:
    """The worst of each number over the picked requests."""
    outs = {r.index: r.out for r in picked}
    worst = {"rel_rms": 0.0, "rel_max": 0.0}
    for i, ref in reference_outputs(cell, traffic, list(outs), seed,
                                    device):
        for k, v in errors(outs[i], ref).items():
            worst[k] = max(worst[k], v)
        del ref
    return worst


def readings(cell, seeds, control_seeds: int, device="cuda"):
    """For each seed, the program's worst numbers over the requests a run
    checks (the lower readings) and, for the first ``control_seeds``
    seeds, the control's: the reference itself computed in float8
    (``Precision('fp8')``) in the program's place (the upper readings). The
    program serves, for each seed, the first requests of the mix's
    schedule: one whole cycle of its shapes, at least as many as a run
    checks. One dict a seed."""
    ref = reference_module(cell.config, cell.root)
    shapes = ref.param_shapes(cell.config["network_g"])
    pred = build_program(cell.config, cell.mix,
                         seeded_params(shapes, seeds[0], device), device)
    for k, seed in enumerate(seeds):
        load_params(pred, seeded_params(shapes, seed, device))
        traffic = Traffic(cell.mix, seed)
        n = max(len(traffic.slots), cell.mix["check"]["requests"])
        done = [Request(i, traffic.shape(i), 0.0,
                        pred.predict_array(traffic.image(i)))
                for i in range(n)]
        picked = sample(done, cell.mix["check"]["requests"], seed)
        outs = {r.index: r.out for r in picked}
        row = {"seed": seed, "program": {}, "control": {}}
        refs = {}
        for i, r in reference_outputs(cell, traffic, list(outs), seed,
                                      device):
            refs[i] = r
            for key, v in errors(outs[i], r).items():
                row["program"][key] = max(row["program"].get(key, 0.0), v)
        if k < control_seeds:
            for i, c in reference_outputs(cell, traffic, list(outs), seed,
                                          device, "fp8"):
                for key, v in errors(c, refs[i]).items():
                    row["control"][key] = max(row["control"].get(key, 0.0),
                                              v)
        del refs
        yield row
