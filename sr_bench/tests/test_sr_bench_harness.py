"""The harness on the CPU at a tiny size: the per-layer readers on a canned
trace, the timeline's reduction, a run with no card, and whole runs (set-up,
window, check) that are sound, that put the control in the program's place,
and that break the timed path underneath."""

import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from sr_bench import harness, run, spec
from sr_bench.harness import Reading
from sr_bench.reference.common import Precision
from sr_bench.trace import WINDOW_SPAN, Timeline
from sr_bench.yardstick import PEAK, attention_bound, gated_ffn_bound
from sr_bench_tiny import NETS, TILED, WHOLE, config

BENCH = spec.load_benchmark()
METRICS = {m["name"]: m for m in BENCH["end_to_end"] + BENCH["per_layer"]}
FFN = "void tc::mma_gated_dconv_ffn_kernel<24>(FfnArgs)"
MSA = "void tc::mma_msa_attention_kernel<32, true, true>(MsaArgs)"
CONV = "cutlass_tensorop_bf16_s16816fprop_optimized_bf16_256x64_nhwc"
D2H = "Memcpy DtoH (Device -> Pageable)"


def _rows(dev):
    """A window of 0..1000 us on thread 1; host spans inside it; device
    ops (name, start_us, end_us)."""
    us = 1000
    rows = [(WINDOW_SPAN, False, 0, 1000 * us, 1),
            ("sr_bench.request", False, 60 * us, 990 * us, 1),
            ("aten::copy_", False, 900 * us, 990 * us, 1),
            ("cudaLaunchKernel", False, 100 * us, 101 * us, 1),
            ("other thread", False, 0, 1000 * us, 2)]
    return rows + [(n, True, s * us, e * us, 0) for n, s, e in dev]


def test_timeline_busy_gaps_and_host_activity():
    tl = Timeline(_rows([(CONV, 100, 300), (FFN, 250, 400),
                         (D2H, 950, 980), ("past the window", 990, 1200)]))
    assert tl.window_s == pytest.approx(1e-3)
    # union: 100-400, 950-980, 990-1000 (clipped)
    assert tl.busy_s == pytest.approx(340e-6)
    gaps = dict(tl.breakdown()["idle_gaps"])
    # each gap goes to the innermost host event under its midpoint
    assert gaps["aten::copy_"] == pytest.approx(10e-6)        # 980-990
    assert gaps["sr_bench.request"] == pytest.approx(550e-6)  # 400-950
    assert gaps[WINDOW_SPAN] == pytest.approx(100e-6)         # 0-100
    ops = dict(tl.breakdown()["device_ops"])
    assert ops[CONV] == pytest.approx(200e-6)
    with pytest.raises(ValueError):
        Timeline(_rows([])[1:])


def _reading(tl, kind="HAT", forwards=((4, 32, 32),), n_requests=2):
    cell = spec.Cell("tiny", 1, config(kind), TILED, {})
    request = spec.load("drivers", "serve_closed_loop").Request
    reqs = [request(i, (16, 16), 0.1 * (i + 1), np.zeros((64, 64, 3)))
            for i in range(n_requests)]
    return Reading(cell, 0.5, n_requests, 0, reqs, list(forwards), 7.0, tl)


def test_readers_on_a_canned_trace():
    launches = sum(NETS["HAT"]["depths"])
    dev = [(FFN, 100 + 10 * i, 105 + 10 * i) for i in range(launches)]
    dev += [(CONV, 600, 700), (D2H, 800, 820)]
    r = _reading(Timeline(_rows(dev)))
    read = {m: spec.reader(m)(r) for m in METRICS}
    busy = launches * 5e-6 + 100e-6 + 20e-6
    assert read["device_idle_pct.upscale"] == pytest.approx(
        100 * (1 - busy / 1e-3))
    assert read["device_idle_pct.serve"] == read["device_idle_pct.upscale"]
    flops = r.flops()
    assert read["mfu.upscale"] == pytest.approx(100 * flops / 1e-3
                                                / PEAK["bf16"])
    bound = launches * gated_ffn_bound(4 * 32 * 32, 24, 48, 24, 2, True)[0]
    assert read["gated_dconv_ffn_roofline"] == pytest.approx(
        100 * bound * 1e-3 / (launches * 5e-6))
    assert read["library_busy_pct.upscale"] == pytest.approx(
        100 * 100 / (100 + launches * 5))
    assert read["d2h_ms.serve"] == pytest.approx(20e-3 / 2)
    assert read["msa_attention_roofline"] is None          # no such kernel
    assert read["setup_s"] == 7.0
    assert read["out_mpix_s"] == pytest.approx(2 * 64 * 64 / 0.5 / 1e6)
    assert read["request_ms_p95"] is None                  # too few requests


def test_msa_roofline_counts_shifted_masks():
    net = NETS["HATClassic"]
    per = [j % 2 == 1 for d in net["depths"] for j in range(d)]
    dev = [(MSA, 100 + 10 * i, 102 + 10 * i) for i in range(len(per))]
    r = _reading(Timeline(_rows(dev)), "HATClassic", ((2, 16, 32),))
    nw = (16 // 8) * (32 // 8)
    bound = sum(attention_bound(2 * nw, 2, 64, 64, 12, 2, nw if s else 0)[0]
                for s in per)
    got = spec.reader("msa_attention_roofline")(r)
    assert got == pytest.approx(100 * bound * 1e-3 / (len(per) * 2e-6))
    # a launch missing: the reading cannot be matched to the forwards
    r = _reading(Timeline(_rows(dev[1:])), "HATClassic", ((2, 16, 32),))
    assert spec.reader("msa_attention_roofline")(r) is None


def test_readers_without_a_trace_read_nothing():
    r = _reading(None)
    for m in BENCH["per_layer"]:
        assert spec.reader(m["name"])(r) is None


def test_request_p95_is_the_quantile_of_all_requests():
    r = _reading(None, n_requests=40)
    ms = [100.0 * (i + 1) for i in range(40)]
    import statistics
    assert spec.reader("request_ms_p95")(r) == pytest.approx(
        statistics.quantiles(ms, n=100)[94])


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "hat_fork_x4.hd_tile", "--seed", "1",
                   "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def _cell(kind, mix, limits_of="hat_classic_x4.hd_tile", trace=False):
    e2e = [m for m in BENCH["end_to_end"] if m["name"] in ("setup_s",
                                                           "out_mpix_s")]
    layer = [METRICS["device_idle_pct.upscale"], METRICS["mfu.upscale"]]
    limits = spec.cell(limits_of, BENCH).limits
    return spec.Cell("tiny", 1, config(kind), mix, limits, e2e, layer)


SEED = 2 ** 31 + 11


@pytest.mark.parametrize("kind,mix", [("HAT", TILED), ("HATClassic", WHOLE)])
def test_a_sound_run_is_correct(kind, mix):
    res = harness.run_cell(_cell(kind, mix), SEED, 0.5, False, "cpu", 0.0)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"setup_s", "out_mpix_s"}
    json.dumps(res)


def test_a_traced_run_reports_the_per_layer_metrics():
    res = harness.run_cell(_cell("HAT", TILED), SEED, 0.5, True, "cpu", 0.0)
    assert res["correct"]
    assert set(res["metrics"]) == {"device_idle_pct.upscale", "mfu.upscale"}
    assert res["device"]["window_s"] > 0 and "breakdown" in res


def _control(pred):
    """The control in the program's place: the reference computed in fp8
    on the same seeded weights."""
    cfg = pred._sr_bench_cell.config
    ref = harness.reference_module(cfg)
    params = {n: p.detach().float().clone()
              for n, p in pred.model.net_g.named_parameters()}
    net, p = cfg["network_g"], Precision("fp8")
    pred.model._apply_fn = lambda: (
        lambda x: ref.forward(params, net, x.float(), p))


def _half_batch(pred):
    """Half of each chunk of tiles left out: the first half's outputs
    stand in for the rest."""
    fwd = pred.model._apply_fn

    def apply():
        f = fwd()

        def half(x):
            k = max(1, x.shape[0] // 2)
            y = f(x[:k])
            return torch.cat([y] * (-(-x.shape[0] // k)))[:x.shape[0]]
        return half
    pred.model._apply_fn = apply


def _altered(pred):
    """An answer altered where it is produced: one 4 x 4 block of each
    request's output off by the output's spread."""
    predict = pred.predict_array

    def altered(lq):
        out = predict(lq).copy()
        out[:4, :4] += out.std()
        return out
    pred.predict_array = altered


# the faults each cell can have: a whole-image request is a batch of one,
# so no half of it can be left out
FAULTS = [(_control, "HAT", TILED), (_half_batch, "HAT", TILED),
          (_altered, "HAT", TILED), (_control, "HATClassic", WHOLE),
          (_altered, "HATClassic", WHOLE)]


@pytest.mark.parametrize("fault,kind,mix", FAULTS,
                         ids=["control-tiled", "half_batch-tiled",
                              "altered-tiled", "control-whole",
                              "altered-whole"])
def test_a_broken_timed_path_is_not_correct(fault, kind, mix):
    cell = _cell(kind, mix)

    def broken(pred):
        pred._sr_bench_cell = cell
        fault(pred)
    res = harness.run_cell(cell, SEED, 0.3, False, "cpu", 0.0, broken)
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
def test_a_cell_on_the_card(card):
    """One short run of each cell through the command, on the card."""
    for w in BENCH["workloads"]:
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = run.main(["--workload", w["name"], "--seed", "5",
                           "--seconds", "3"])
        res = json.loads(buf.getvalue().strip().splitlines()[-1])
        assert rc == 0 and res["correct"], res
        assert res["device"]["platform"] == "gpu"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
