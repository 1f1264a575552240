"""Cells whose ranks run in processes of their own (``portbench/ranks.py``),
on two CPU ranks over Gloo at a small size: the cohort cell is correct and
its control is caught; a timed path broken on every rank, and a worker that
raises, exits or stalls, end the run with ``correct`` false inside the
deadline and leave no process behind; the card's kernel time and the cards
are counted over the ranks; and a one-card cell's run loads nothing of
``ranks.py``."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from _small import RANKS, ROOT, SEED, bench, run_small, sizes, small_bench

from portbench import ranks, trace
from portbench.controls import control_readings
from portbench.harness import BENCH_DIR, load_module

CELL = "v3.cohort_stats"


def test_the_cohort_cell_is_correct_on_two_ranks():
    result, checks = run_small(CELL, seconds=0.5)
    assert result["correct"] and result["failed"] == 0
    assert checks["fields_wrong"][0] == 0 and checks["ranks_wrong"][0] == 0
    assert checks["jobs_compared"][0] == result["attempted"] >= 1


def test_the_control_reads_every_ranks_fields_wrong():
    readings = control_readings(small_bench(), CELL, SEED, sizes(CELL))
    # the merge without the last rank's state: four fields wrong on each rank
    assert readings["fields_wrong"] == (4 * RANKS, 0)
    assert readings["ranks_wrong"] == (0, 0)


def test_the_card_readings_of_the_ranks_are_summed():
    readings = [{"busy_s": 0.5, "kernel_s": 0.25}, {"busy_s": 0.75, "kernel_s": 0.125},
                {"busy_s": 1.0, "kernel_s": 0.5}, {"busy_s": 0.25, "kernel_s": 0.125}]
    card = ranks.summed_card(readings)
    assert card == {"busy_s": 2.5, "kernel_s": 1.0}
    assert ranks.summed_card(readings[:3] + [None]) is None
    # card-milliseconds per 10^6 records of every rank: 1,000 ms over 40 x 10^6 records
    run = {"card": card, "window": {"records": 4 * 10**7}}
    assert load_module("metrics", "kernel_ms_per_mrecord").read(run) == pytest.approx(25.0)


def test_distinct_cards_are_counted_once():
    four = [[(f"GPU-{r}", 100 + r)] for r in range(4)]
    assert ranks.count_cards(four) == (4, 103)
    # two ranks on one card: one card, its peak the two added
    assert ranks.count_cards([[("GPU-0", 100)], [("GPU-0", 50)]]) == (1, 150)
    assert ranks.count_cards([[], []]) == (0, 0)


def test_the_rank_spread_is_the_median_over_the_jobs():
    read = load_module("metrics", "rank_spread_pct").read
    # the call times, all alike as every rank waits in the merge, are not read
    run = {"trace": {}, "ranks": [{"job_s": [5.0] * 4, "to_merge_s": [1.0, 2.0, 4.0, None]},
                                  {"job_s": [5.0] * 4, "to_merge_s": [0.9, 1.0, 3.0, 1.0]}]}
    assert read(run) == pytest.approx(25.0)  # spreads 10%, 50%, 25%; the fourth has no reading
    assert read({**run, "trace": None}) is None
    assert read({"trace": {}, "ranks": run["ranks"][:1]}) is None
    # traces of different lengths do not line up job by job
    short = {"to_merge_s": [1.0, 2.0]}
    assert read({"trace": {}, "ranks": [run["ranks"][0], short]}) is None
    assert read({"trace": {}, "ranks": [{"to_merge_s": None}, short]}) is None


def _event(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "pid": 1}


def test_the_time_to_the_merge_runs_from_the_call_to_the_collective(tmp_path):
    events = [
        _event("job", "user_annotation", 100, 900),
        _event("multihost_file_stats", "user_annotation", 110, 880),
        _event("h2d.stage", "user_annotation", 120, 300),
        _event("c10d::allgather_", "cpu_op", 710, 5),
        _event("gloo:all_gather", "user_annotation", 600, 390, tid=2),  # Gloo's own thread
        _event("c10d::allgather_", "cpu_op", 800, 5),  # a later collective of the job
        _event("job", "user_annotation", 2000, 500),
        _event("multihost_file_stats", "user_annotation", 2010, 480),  # no collective
        _event("job", "user_annotation", 3000, 500),
        _event("c10d::allgather_", "cpu_op", 3100, 5),  # no call into the program
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert trace.collective_offsets(str(path)) == [pytest.approx(600e-6), None, None]


def test_a_traced_run_reads_every_ranks_time_to_the_merge():
    result, checks = run_small(CELL, seconds=0.5, trace=True)
    assert result["correct"] and checks["ranks_wrong"][0] == 0
    assert 0 <= result["metrics"]["rank_spread_pct"]["value"] < 100


ONE_CARD = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[2])
import torch
from _small import run_small
result, _ = run_small("v3.stream_stats", seconds=0.2)
print(json.dumps({"correct": result["correct"],
                  "loaded": sorted(n for n, m in sys.modules.items()
                                   if n.endswith("ranks") or "ranks.py" in str(getattr(m, "__file__", "")))}))
"""


def test_a_one_card_cell_loads_nothing_of_ranks():
    out = subprocess.run([sys.executable, "-c", ONE_CARD, str(ROOT), str(Path(__file__).parent)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    found = json.loads(out.stdout.strip().splitlines()[-1])
    assert found == {"correct": True, "loaded": []}


# ---------------------------------------------------------------------------
# faults, each planted in a copy of the benchmark as a job of its own, so that
# every rank's process loads it
# ---------------------------------------------------------------------------

FAULT_JOB = '''
"""The cohort_stats job with a fault planted on every rank, or on rank 1."""
import os
import time

import numpy as np

from portbench.jobs import cohort_stats as base
from portbench.jobs.cohort_stats import LIMITS, compare, control, reference  # noqa: F401

#: calls of a rank's set-up (the warm-up): a fault of rank 1 comes after
WARM_CALLS = 2


def plant(fault):
    import ibu_tpu_torch.parallel.device as device_mod
    import ibu_tpu_torch.parallel.multihost as mh

    if fault == "unchanged":
        mh.STATS_MAP_REDUCE = device_mod.MapReduce(init=device_mod._stats_init,
                                                   update=lambda state, r: state)
    elif fault == "half":
        real = mh.local_record_batches
        mh.local_record_batches = lambda *a, **k: (b[: len(b) // 2] for b in real(*a, **k))
    elif fault == "exchange":
        device_mod._gather_state_tree = lambda tree, failed=None: device_mod._tree_map(
            lambda x: np.asarray(x)[None], tree)
    elif fault == "altered":
        real_sums = device_mod.field_sums

        def altered(records):  # one more on the barcode sum of each batch
            out = real_sums(records).clone()
            out[0] += 1
            return out

        device_mod.field_sums = altered


def prepare(ctx):
    state = base.prepare(ctx)
    state.update(rank=ctx.get("rank", 0), fault=ctx["params"]["fault"], calls=0)
    plant(state["fault"])
    return state


def run(state, i):
    state["calls"] += 1
    if state["rank"] == 1 and state["calls"] > WARM_CALLS:
        if state["fault"] == "raises":
            raise RuntimeError("a fault planted in rank 1")
        if state["fault"] == "exits":
            os._exit(3)
        if state["fault"] == "stalls":
            time.sleep(3600)
    return base.run(state, i)
'''

DRIVE = """
import json, sys, time
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch
from portbench import harness, ranks
ranks.DEADLINE_S = float(sys.argv[5])
bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
t0 = time.perf_counter()
result, _ = harness.run_cell(bench, sys.argv[3], 7, 1.0, False, torch.device("cpu"), t0,
                             sizes=json.loads(sys.argv[4]))
print(json.dumps({"result": result, "seconds": time.perf_counter() - t0}))
"""

#: seconds a worker of the fault cells has to answer
DEADLINE_S = 5
FAULTS = ["unchanged", "half", "exchange", "altered", "raises", "exits", "stalls"]


def _processes_running(path: str) -> list[int]:
    """Processes whose command line names ``path``."""
    found = []
    for entry in Path("/proc").iterdir():
        if entry.name.isdigit():
            try:
                if path in (entry / "cmdline").read_bytes().decode(errors="replace"):
                    found.append(int(entry.name))
            except OSError:
                pass
    return found


def _run_fault(tmp_path, fault: str) -> tuple[dict, float, str]:
    """Copy the benchmark, add the fault job and a two-rank cell of it, and
    run the cell; the result, the run's seconds and its standard error."""
    shutil.copytree(BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "portbench/jobs/cohort_fault.py").write_text(FAULT_JOB)
    (tmp_path / "portbench/traffic/cohort_fault.json").write_text(json.dumps({"job": "cohort_fault"}))
    cell = f"fault.{fault}"
    (tmp_path / f"portbench/workloads/{cell}.json").write_text(json.dumps({"fault": fault}))
    b = bench()
    b["workloads"].append({"name": cell, "config": "chromium3p_v3", "traffic": "cohort_fault",
                           "chips": RANKS, "why": "a planted fault"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    out = subprocess.run([sys.executable, "-c", DRIVE, str(tmp_path), str(ROOT), cell,
                          json.dumps(sizes(CELL)), str(DEADLINE_S)],
                         capture_output=True, text=True, timeout=240, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert not _processes_running(str(tmp_path / "portbench" / "ranks.py"))
    done = json.loads(out.stdout.strip().splitlines()[-1])
    return done["result"], done["seconds"], out.stderr


@pytest.mark.parametrize("fault", FAULTS)
def test_a_fault_on_the_ranks_ends_the_run_not_correct(fault, tmp_path):
    result, seconds, err = _run_fault(tmp_path, fault)
    assert not result["correct"], err[-3000:]
    # set-up, a 1-s window, and at most one deadline
    assert seconds < 60 + DEADLINE_S
    if fault in ("raises", "exits", "stalls"):
        assert result["failed"] == 1
    else:
        assert result["failed"] == 0 and result["checks"]["fields_wrong"]["value"] > 0


def test_the_fault_job_with_no_fault_is_correct(tmp_path):
    """The faults above are the only cause of their verdicts."""
    result, _, err = _run_fault(tmp_path, "none")
    assert result["correct"] and result["failed"] == 0, err[-3000:]
