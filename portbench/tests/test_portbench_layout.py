"""BENCHMARK.json against the benchmark's contract, and the harness finding
every configuration, cell, traffic mix, job and metric by name."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from _small import ROOT, bench

from portbench.harness import BENCH_DIR, cell_metrics, cell_spec, load_module

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def test_top_level_keys_and_limits():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "portbench/run.py"]
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p for p in b["paths"])
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries_have_the_contract_keys():
    b = bench()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert set(c["reduced"]) == set(cfg["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert TEXT.match(w["why"]) and w["chips"] in (1, 4)
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert TEXT.match(m["layer"]) and m["moves"] in {e["name"] for e in b["end_to_end"]}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(b["workloads"])
    assert {w["config"] for w in b["workloads"]} == {c["name"] for c in b["configs"]}


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_every_cell_is_found_by_name(cell):
    b = bench()
    spec = cell_spec(b, cell)
    job = load_module("jobs", spec["params"]["job"])
    for fn in ("prepare", "run", "reference", "compare", "control"):
        assert callable(getattr(job, fn))
    e2e = {m["name"] for m in cell_metrics(b, cell, trace=False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell_metrics(b, cell, trace=True)
    for m in cell_metrics(b, cell, False) + cell_metrics(b, cell, True):
        assert callable(load_module("metrics", m["name"]).read)


def test_per_layer_workloads_name_cells():
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"] + b["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells


NEW_CONFIG = {"name": "tiny_dropseq", "source": "a copy of dropseq at a size a test holds",
              "file": "portbench/configs/tiny_dropseq.json", "reduced": ["reads", "cells"],
              "why": "a configuration added as a file"}
NEW_CELL = {"name": "tiny.sort", "config": "tiny_dropseq", "traffic": "sort", "chips": 1,
            "why": "a cell added as files"}
NEW_METRIC = {"name": "jobs_traced", "unit": "jobs", "better": "higher", "source": "device_trace",
              "layer": "device (H100)", "moves": "kernel_ms_per_mrecord", "workloads": ["tiny.sort"]}

DRIVE = """
import json, sys, time
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch
from portbench import harness
assert harness.BENCH_DIR.parent == __import__("pathlib").Path(sys.argv[1]).resolve()
bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
for trace in (False, True):
    result, _ = harness.run_cell(bench, "tiny.sort", 7, 0.2, trace, torch.device("cpu"),
                                 time.perf_counter())
    print(json.dumps(result))
"""


def test_a_cell_config_and_metric_added_as_files_run(tmp_path):
    """Copy the benchmark, add a configuration, a cell and a metric as new
    files with their entries, and run the new cell: no file that was there
    changes."""
    shutil.copytree(BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    cfg = json.loads((BENCH_DIR / "configs" / "dropseq.json").read_text())
    cfg.update(name="tiny_dropseq", reads=40000, cells=200, ambient_barcodes=2000)
    cfg["reduced"] = {"reads": "a test's size", "cells": "a test's size"}
    (tmp_path / "portbench/configs/tiny_dropseq.json").write_text(json.dumps(cfg))
    (tmp_path / "portbench/workloads/tiny.sort.json").write_text(
        json.dumps({"batch_records": 4096}))
    (tmp_path / "portbench/metrics/jobs_traced.py").write_text(
        "def read(run):\n    t = run['trace']\n    return None if t is None else len(t['jobs'])\n")
    b = bench()
    b["configs"].append(NEW_CONFIG)
    b["workloads"].append(NEW_CELL)
    b["per_layer"].append(NEW_METRIC)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))

    out = subprocess.run([sys.executable, "-c", DRIVE, str(tmp_path), str(ROOT)],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    plain, traced = (json.loads(line) for line in out.stdout.strip().splitlines()[-2:])
    assert plain["correct"] and traced["correct"]
    # the card's metrics need a card: on the CPU only the host's clock reads
    assert set(plain["metrics"]) == {"setup_s"}
    assert traced["metrics"]["jobs_traced"]["value"] >= 1
    for rel, data in before.items():
        assert (tmp_path / rel).read_bytes() == data
