"""BENCHMARK.json against the contract's shape, every name resolving to its
files, a new cell being only new files and entries, and the import rule."""

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from sr_bench import spec

ROOT = spec.REPO_ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(BENCH) == KEYS
    assert BENCH["paths"] == ["sr_bench"]
    assert BENCH["command"] == ["python3", "-m", "sr_bench.run"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_run_seconds_fit_a_full_check_of_24_cells():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_entries_have_the_contract_keys(section):
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source",
                              "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer",
                             "moves", "workloads"}}[section]
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert set(e) <= allowed, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]


def test_bounds_and_sources():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    assert all(m["moves"] in e2e for m in BENCH["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_to_its_files(cell):
    c = spec.cell(cell, BENCH)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(m["name"]))
        if "workloads" in m and m in c.per_layer:
            assert m["moves"] in names
    assert set(c.limits) == {"rel_rms", "rel_max"}
    assert c.chips == 1
    for k in ("shapes", "check"):
        assert k in c.mix
    assert (ROOT / "sr_bench" / "reference"
            / f"{c.config['reference']}.py").exists()


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_files_are_under_paths_and_uncut(entry):
    path = ROOT / entry["file"]
    assert entry["file"].startswith("sr_bench/configs/") and path.exists()
    config = json.loads(path.read_text())
    assert config["name"] == entry["name"]
    assert entry["reduced"] == []
    net = config["network_g"]
    assert (net["embed_dim"], net["depths"], net["window_size"]) == (
        180, [6] * 6, 16)


def test_every_metric_file_is_named_in_benchmark():
    named = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    files = {p.name[:-3] for p in (ROOT / "sr_bench" / "metrics").glob("*.py")}
    assert files == named


# the files a later PR would add for a new network trained by a new kind
# of traffic: its reference, its driver, its mix, its limits, a metric
TOY_REFERENCE = """
import torch.nn.functional as F


def param_shapes(net):
    c, s = net["in_chans"], net["upscale"]
    return {"conv.weight": (c * s * s, c, 3, 3), "conv.bias": (c * s * s,)}


def forward(params, net, x, p=None):
    y = F.conv2d(x.permute(0, 3, 1, 2), params["conv.weight"],
                 params["conv.bias"], padding=1)
    return F.pixel_shuffle(y, net["upscale"]).permute(0, 2, 3, 1)


def flops(net, b, h, w):
    c, s = net["in_chans"], net["upscale"]
    return 2 * b * h * w * 9 * c * c * s * s
"""
TOY_DRIVER = """
import time

import torch
from torch.profiler import record_function

from sr_bench.harness import Reading, reference_module
from sr_bench.trace import WINDOW_SPAN
from sr_bench.weights import seeded_params


class Run:
    def __init__(self, cell, seed, device):
        self.cell, self.net = cell, cell.config["network_g"]
        self.ref = reference_module(cell.config, cell.root)
        self.start = seeded_params(self.ref.param_shapes(self.net), seed,
                                   device)
        self.program = {k: v.clone().requires_grad_()
                        for k, v in self.start.items()}
        self.opt = torch.optim.Adam(self.program.values(), lr=1e-3)
        b, (h, w) = cell.mix["batch"], cell.mix["lr"]
        g = torch.Generator(device).manual_seed(seed)
        self.x = torch.rand(b, h, w, 3, generator=g, device=device)
        self.y = torch.rand(b, h * 2, w * 2, 3, generator=g, device=device)

    def window(self, seconds):
        with record_function(WINDOW_SPAN):
            t0, self.losses = time.perf_counter(), []
            while not self.losses or time.perf_counter() - t0 < seconds:
                loss = (self.ref.forward(self.program, self.net, self.x)
                        - self.y).abs().mean()
                self.opt.zero_grad()
                loss.backward()
                self.opt.step()
                self.losses.append(float(loss.detach()))
            window_s = time.perf_counter() - t0
        n = len(self.losses)
        return Reading(self.cell, window_s, n, 0,
                       forwards=[tuple(self.x.shape[:3])] * n)

    def free(self):
        self.program = None

    def check(self, reading):
        with torch.no_grad():
            first = (self.ref.forward(self.start, self.net, self.x)
                     - self.y).abs().mean()
        return {"loss_gap": abs(self.losses[0] - float(first))}
"""


@pytest.mark.parametrize("trace", [False, True])
def test_a_new_cell_is_only_new_files_and_entries(tmp_path, trace):
    """A network of a type the benchmark has not seen, trained by a kind
    of traffic it has no driver for, added as files (configuration,
    reference with its FLOP counter, driver, mix, limits, metrics) with
    entries in a copy of BENCHMARK.json: the cell runs end to end on the
    CPU with no file of the benchmark changed."""
    from sr_bench import harness

    shutil.copytree(ROOT / "sr_bench", tmp_path / "sr_bench")
    here = tmp_path / "sr_bench"
    net = {"type": "ToyUpsampler", "in_chans": 3, "upscale": 2}
    files = {
        "configs/toy_x2.json": json.dumps(
            {"name": "toy_x2", "scale": 2, "network_g": net,
             "reference": "toy_upsampler"}),
        "reference/toy_upsampler.py": TOY_REFERENCE,
        "drivers/train_steps.py": TOY_DRIVER,
        "mixes/toy_steps.json": json.dumps(
            {"driver": "train_steps", "batch": 2, "lr": [8, 12]}),
        "limits/toy_x2.toy_steps.json": json.dumps(
            {"loss_gap": {"limit": 1e-5}}),
        "metrics/steps_s.py":
            "def read(r):\n    return r.attempted / r.window_s\n",
        "metrics/mfu.toy.py":
            "def read(r):\n    return 3 * r.flops() / r.window_s\n",
    }
    for name, text in files.items():
        assert not (here / name).exists()
        (here / name).write_text(text)
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "toy_x2", "source": "x",
                             "file": "sr_bench/configs/toy_x2.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "toy_x2.toy_steps",
                               "config": "toy_x2", "traffic": "toy_steps",
                               "chips": 1, "why": "x"})
    bench["end_to_end"].append({"name": "steps_s", "unit": "1/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["toy_x2.toy_steps"]})
    bench["per_layer"].append({"name": "mfu.toy", "unit": "FLOP/s",
                               "better": "higher", "source": "host_clock",
                               "layer": "train step", "moves": "steps_s",
                               "workloads": ["toy_x2.toy_steps"]})
    cell = spec.cell("toy_x2.toy_steps", bench, tmp_path)
    res = harness.run_cell(cell, 2 ** 31 + 5, 0.2, trace, "cpu", 0.0)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == {"loss_gap"}
    want = {"mfu.toy"} if trace else {"steps_s", "setup_s"}
    assert set(res["metrics"]) == want
    for m in res["metrics"].values():
        assert m["value"] > 0


def test_a_limit_without_its_number_fails(tmp_path):
    """A driver that gives no number for one of the cell's limits does not
    pass it."""
    from sr_bench import harness

    cell = spec.cell("hat_classic_x4.hd_tile", BENCH)
    shutil.copytree(ROOT / "sr_bench", tmp_path / "sr_bench")
    (tmp_path / "sr_bench" / "drivers" / "silent.py").write_text(
        "from sr_bench.harness import Reading\n\n\n"
        "class Run:\n"
        "    program = None\n\n"
        "    def __init__(self, cell, seed, device):\n"
        "        self.cell = cell\n\n"
        "    def window(self, seconds):\n"
        "        return Reading(self.cell, 1.0, 1, 0)\n\n"
        "    def free(self):\n"
        "        pass\n\n"
        "    def check(self, reading):\n"
        "        return {'rel_rms': 0.0}\n")
    cell = spec.Cell("silent", 1, cell.config, {"driver": "silent"},
                     cell.limits, [], [], tmp_path)
    res = harness.run_cell(cell, 1, 0.1, False, "cpu", 0.0)
    assert not res["correct"]
    assert res["checks"]["rel_max"]["value"] == float("inf")


FORBIDDEN = {"jax", "jaxlib", "flax", "super_resolution_tpu"}


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module":
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                tops.add(arg.value.split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted((ROOT / "sr_bench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_import_rule(path):
    """No file imports JAX or the JAX package, compared by whole top-level
    names (the port's name begins with the JAX package's); the reference
    imports nothing of the port either."""
    tops = _imports(path)
    assert not tops & FORBIDDEN
    if "reference" in path.parts:
        assert "super_resolution_tpu_torch" not in tops


def test_the_run_loads_no_jax():
    code = ("import sys; import sr_bench.run, sr_bench.harness, "
            "sr_bench.calibrate, super_resolution_tpu_torch.predict; "
            "from sr_bench import spec; "
            "[spec.load('drivers', d.stem) for d in "
            "(spec.BENCH_DIR / 'drivers').glob('*.py')]; "
            "from sr_bench.run import forbidden_modules; "
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    assert out.stdout.strip() == "[]"


def test_forbidden_names_compare_whole(monkeypatch):
    from sr_bench.run import forbidden_modules

    for name in list(sys.modules):
        if name.split(".")[0] in FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "super_resolution_tpu_torch.x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "super_resolution_tpu.ops", sys)
    assert forbidden_modules() == ["jax", "super_resolution_tpu"]
