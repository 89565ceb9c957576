"""``BENCHMARK.json`` and the files it names, found by name.

A cell of ``workloads`` names its configuration (``configs/<config>.json``
through the entry's ``file``) and its traffic mix (``mixes/<traffic>.json``);
its correctness limits are ``limits/<cell>.json``. The configuration names
its plain reference (``reference/<reference>.py``: parameters, forward,
FLOP counter), the mix names the driver that runs its set-up, window and
check (``drivers/<driver>.py``), and each metric is read by
``metrics/<metric>.py``. A later cell, mix, configuration, network, kind of
traffic or metric is a new file and a new entry: nothing here names one.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import re
import sys
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
REPO_ROOT = BENCH_DIR.parent


def load_benchmark(root: Path = REPO_ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One entry of ``workloads`` with what it names."""

    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)
    root: Path = REPO_ROOT


def _applies(metric: dict, cell: str, reported: set) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    list, else every cell (an end-to-end metric) or every cell that reports
    the end-to-end metric it ``moves`` (a per-layer one)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def cell(name: str, bench: dict | None = None,
         root: Path = REPO_ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files read."""
    bench = bench or load_benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r}; one of {sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / configs[entry["config"]]["file"])
    here = root / BENCH_DIR.name
    mix = _json(here / "mixes" / f"{entry['traffic']}.json")
    limits = _json(here / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, name, reported)]
    return Cell(name, entry["chips"], config, mix, limits, e2e, per_layer,
                root)


@functools.lru_cache(maxsize=None)
def load(kind: str, name: str, root: Path = REPO_ROOT):
    """The module ``<kind>/<name>.py`` of the benchmark's folder under
    ``root``: a reference, a driver or a metric's reader, by its name."""
    path = root / BENCH_DIR.name / kind / f"{name}.py"
    module_name = "sr_bench_" + re.sub(r"\W", "_", f"{kind}_{name}")
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = module
    spec.loader.exec_module(module)
    return module


def reader(metric: str, root: Path = REPO_ROOT):
    """The ``read(reading)`` function of ``metrics/<metric>.py``."""
    return load("metrics", metric, root).read
