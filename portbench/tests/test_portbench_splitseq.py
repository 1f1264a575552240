"""The ``splitseq.histogram`` and ``v3.encode_sort`` cells: each comparison on
the CPU at a small size against the port, one flipped bit and the control;
the SPLiT-seq traffic's claims at the cell's full size; the plain torch
reference; and the three metrics read from the program's spill and write
spans and counters."""

from __future__ import annotations

import ast
import contextlib
import json
import sys
import time

import numpy as np
import pytest
import torch

from _small import ROOT, SEED, bench

from portbench import harness, plain_torch
from portbench.harness import cell_spec, load_module
from portbench.reference import plain
from portbench.traffic import generate

from ibu_tpu_torch.utils import trace

#: the cells at a CPU's size; the histogram's table holds a fraction of the
#: file's barcodes, as the cell's does, so the spill lane works
SIZES = {
    "splitseq.histogram": {
        "cfg": {"reads": 60000, "cells": 300, "ambient_barcodes": 3000},
        "params": {"stream_batch_records": 8192, "max_uniques_per_shard": 8192,
                   "capacity": 1024}},
    "v3.encode_sort": {"cfg": {}, "params": {"batch_records": 8192, "batches": 2}},
}
CELLS = tuple(SIZES)


def _job_state(cell: str, tmp_path):
    spec = cell_spec(bench(), cell)
    cfg = {**spec["cfg"], **SIZES[cell]["cfg"]}
    params = {**spec["params"], **SIZES[cell]["params"]}
    job = load_module("jobs", params["job"])
    state = job.prepare({"cfg": cfg, "params": params, "seed": SEED, "cell": cell,
                         "workdir": str(tmp_path)})
    state.update(device=torch.device("cpu"), span=lambda name: contextlib.nullcontext())
    return job, state


@pytest.mark.parametrize("cell", CELLS)
def test_the_port_passes_a_flipped_bit_and_the_control_fail(cell, tmp_path):
    job, state = _job_state(cell, tmp_path)
    ref = job.reference(state)
    kept = [(i, job.run(state, i)) for i in range(state["distinct"])]
    assert all(v == 0 for v in job.compare(state, ref, kept).values())
    _, out = kept[-1]
    if cell == "v3.encode_sort":
        out["records"][5, 2] ^= np.uint64(1)
    else:
        out[next(iter(out))] += 1
    assert sum(job.compare(state, ref, kept).values()) == 1
    found = job.compare(state, ref, job.control(state))
    assert all(found[k] > job.LIMITS[k] for k in found if k != "header_wrong"), found


def test_a_flipped_sorted_flag_is_a_wrong_header(tmp_path):
    job, state = _job_state("v3.encode_sort", tmp_path)
    out = job.run(state, 0)
    out["sorted"] ^= 1
    assert job.compare(state, job.reference(state), [(0, out)]) == {
        "records_wrong": 0, "header_wrong": 1}


def test_encode_sort_keeps_one_file_a_distinct_batch(tmp_path):
    job, state = _job_state("v3.encode_sort", tmp_path)
    for i in range(3 * state["distinct"]):
        job.run(state, i)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"v3.encode_sort.{k}.ibu" for k in range(state["distinct"])]


@pytest.mark.parametrize("seed", [7, 11, 2**31 + 3, 2**32 + 17, 6_000_000_019])
def test_splitseq_traffic_claims(seed):
    """At the cell's size: every 2^20-record stream batch holds fewer
    distinct barcodes than ``max_uniques_per_shard`` and more than half of
    it, and the file more than the 2^20-slot table."""
    spec = cell_spec(bench(), "splitseq.histogram")
    cfg, params = spec["cfg"], spec["params"]
    bc = generate.sample(cfg, cfg["reads"], seed)["barcode"]
    batch = params["stream_batch_records"]
    most = max(len(np.unique(bc[s:s + batch])) for s in range(0, len(bc), batch))
    assert params["max_uniques_per_shard"] // 2 < most < params["max_uniques_per_shard"]
    assert len(np.unique(bc)) > params["capacity"]
    assert int((bc >> np.uint64(32)).max()) > 0  # the 64-bit key path


def test_the_plain_torch_counts_equal_the_numpy_ones():
    bc = np.array([5, 2**63, 2**64 - 1, 5, 0, 2**63, 2**40 + 1], dtype=np.uint64)
    keys, counts = plain_torch.counts(bc)
    want_k, want_c = plain.counts(bc)
    assert np.array_equal(keys.numpy().view(np.uint64), want_k)
    assert np.array_equal(counts.numpy(), want_c)
    assert plain_torch.counts_dict(torch.from_numpy(bc.view(np.int64))) == dict(
        zip(want_k.tolist(), want_c.tolist()))


def test_the_plain_torch_reference_imports_nothing_of_the_program():
    tree = ast.parse((ROOT / "portbench" / "plain_torch.py").read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert names == {"__future__", "numpy", "torch"}


def test_the_splitseq_configuration_states_its_cut():
    entry = next(c for c in bench()["configs"] if c["name"] == "splitseq")
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert entry["reduced"] == list(cfg["reduced"]) == ["reads"]
    assert (cfg["bc_len"], cfg["umi_len"]) == (24, 10)
    assert cfg["cells"] + cfg["ambient_barcodes"] == cfg["barcode_space"] == 96**3
    assert cfg["sample_reads"] // cfg["reads"] == 52


MS = 1_000_000
#: metric → its reading of :func:`_session` and :data:`RUN`
EXPECTED = {
    "hist_spilled_per_job": 150.0,  # 100 + 200 groups over 2 jobs
    "hist_spill_ms_per_job": 2.5,  # 2 + 3 ms over 2 jobs
    "write_gbps": 2.0,  # 6e6 B over 3 ms of file.write's self time
}
RUN = {"window": {"job_s": [0.05, 0.05], "records": 2000, "wall_s": 0.1},
       "setup_s": 1.0, "trace": {"jobs_s": 0.1}, "card": None}


def _session() -> list:
    """Two calls: (name, parent index, start ms, end ms, counters)."""
    rows = [("ibu.stream_file_histogram", None, 0, 20, {"records": 1000}),
            ("hist.merge", 0, 1, 6, {}),
            ("hist.spill", 1, 2, 4, {"hist_spilled_groups": 100}),
            ("d2h.wait", 2, 2, 3, {"d2h_bytes": 8000}),
            ("hist.spill", 0, 10, 13, {"hist_spilled_groups": 200}),
            ("ibu.encode_sorted_file", None, 30, 40, {}),
            ("file.write", 5, 31, 35, {"written_bytes": 6_000_000}),
            ("h2d.pinned_alloc", 6, 31, 32, {})]
    spans = []
    for name, parent, t0, t1, counters in rows:
        s = trace.Span(name, len(spans), None if parent is None else spans[parent], 1)
        s.start_ns, s.end_ns, s.counters = t0 * MS, t1 * MS, dict(counters)
        spans.append(s)
    return spans


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reading_of_a_synthetic_session(name, monkeypatch):
    monkeypatch.setattr(trace, "session", _session)
    assert load_module("metrics", name).read(RUN) == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_silent_untraced_with_nothing_recorded_or_without_a_tracer(name, monkeypatch):
    read = load_module("metrics", name).read
    monkeypatch.setattr(trace, "session", _session)
    assert read({**RUN, "trace": None}) is None
    root = _session()[0]
    monkeypatch.setattr(trace, "session", lambda: [root])
    assert read(RUN) is None
    monkeypatch.setitem(sys.modules, "ibu_tpu_torch.utils.trace", None)
    assert read(RUN) is None


@pytest.mark.parametrize("cell, names", [
    ("splitseq.histogram", {"hist_spilled_per_job", "hist_spill_ms_per_job"}),
    ("v3.encode_sort", {"write_gbps"}),
])
def test_a_traced_cpu_run_reports_the_cells_new_metrics(cell, names, capsys):
    args = harness.parse_args(["--workload", cell, "--seed", str(SEED), "--seconds", "0.3",
                               "--trace", "1"])
    rc = harness.run_and_report(bench(), args, torch.device("cpu"), 0.0, sizes=SIZES[cell])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and result["correct"]
    assert names <= set(result["metrics"]) and all(
        result["metrics"][n]["value"] > 0 for n in names)
    assert {m["name"] for m in bench()["per_layer"] if cell in m.get("workloads", ())} == names


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_on_the_card_reports_the_cells_new_metrics(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result, _ = harness.run_cell(bench(), cell, SEED, 1.0, True, torch.device("cuda"),
                                 time.perf_counter(), sizes=SIZES[cell])
    names = {m["name"] for m in bench()["per_layer"] if cell in m.get("workloads", ())}
    assert result["correct"] and result["device"]["busy_s"] > 0
    assert all(result["metrics"][n]["value"] > 0 for n in names)
