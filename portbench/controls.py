"""The controls of the cells' comparisons, at a cell's own size:

    python3 portbench/controls.py --workload <cell> --seeds 1,2,3

For each seed it makes the cell's inputs, puts the job's control (the plain
reference with one of the configuration's guarantees broken) in the
program's place and prints the numbers the cell compares, each beside its
limit: a control that passes no limit shows that the comparison catches
what it breaks. The benchmark's own runs never run a control.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.harness import ROOT, cell_spec, load_json, load_module  # noqa: E402


def control_readings(bench: dict, cell: str, seed: int, sizes: dict | None = None) -> dict:
    """``{name: (value, limit)}`` of the control of ``cell`` on ``seed``."""
    spec = cell_spec(bench, cell)
    cfg = {**spec["cfg"], **(sizes or {}).get("cfg", {})}
    params = {**spec["params"], **(sizes or {}).get("params", {})}
    job = load_module("jobs", params["job"])
    workdir = tempfile.mkdtemp(prefix="portbench-control-")
    try:
        state = job.prepare({"cfg": cfg, "params": params, "seed": seed, "cell": cell,
                             "workdir": workdir})
        found = job.compare(state, job.reference(state), job.control(state))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return {name: (found[name], limit) for name, limit in job.LIMITS.items()}


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = ap.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    failed_all = True
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        readings = control_readings(bench, args.workload, seed)
        caught = any(v > lim for v, lim in readings.values())
        failed_all &= caught
        print(json.dumps({"workload": args.workload, "seed": seed, "control_caught": caught,
                          "readings": {k: {"value": v, "limit": lim} for k, (v, lim) in readings.items()},
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
