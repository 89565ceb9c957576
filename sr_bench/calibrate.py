"""The readings that a cell's correctness limits are set from, on the card
at the cell's own sizes, in one process:

    python3 -m sr_bench.calibrate --workload <cell> --seeds 1 2 3 \
        --control-seeds 3

The cell's driver (``drivers/<driver>.py``, ``readings``) gives, for each
seed, the program's numbers (the lower readings) and, for the first
``--control-seeds`` seeds, the control's (the upper readings). One JSON
line a seed, then a summary line with each number's least and largest.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from sr_bench import spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    driver = spec.load("drivers", cell.mix["driver"], cell.root)
    rows = []
    for row in driver.readings(cell, args.seeds, args.control_seeds,
                               "cuda"):
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"workload": args.workload,
               "kind": torch.cuda.get_device_name(0)}
    for side in ("program", "control"):
        for key in sorted({k for r in rows for k in r[side]}):
            vals = [r[side][key] for r in rows if key in r[side]]
            summary[f"{side}.{key}"] = [min(vals), max(vals)]
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
