"""``sort_passes_per_job``: the program's ``sort_passes`` counter over the
traced jobs, on a synthetic session; silent where the run is untraced,
where nothing was counted and where the program has no tracer; and a traced
run of the sort cell on the card, where it reads 7 (a Drop-seq key is 24 +
16 + 16 bits)."""

from __future__ import annotations

import sys

import pytest
import torch

from _small import bench, run_small

from portbench.harness import load_module

from ibu_tpu_torch.utils import trace

MS = 1_000_000
RUN = {"window": {"job_s": [0.05, 0.05, 0.05], "records": 3 * 4096, "wall_s": 0.15},
       "setup_s": 1.0, "trace": {"jobs_s": 0.15}, "card": None}


def _session() -> list:
    """Three sort calls: 7 passes each, one inside a child span; (name,
    parent index, start ms, end ms, counters)."""
    rows = [("ibu.sort_batch", None, 0, 5, {"records": 4096, "sort_passes": 7}),
            ("ibu.sort_batch", None, 5, 10, {"records": 4096, "sort_passes": 7}),
            ("ibu.sort_batch", None, 10, 15, {"records": 4096}),
            ("d2h.wait", 2, 11, 12, {"d2h_bytes": 24, "sort_passes": 7})]
    spans = []
    for name, parent, t0, t1, counters in rows:
        s = trace.Span(name, len(spans), None if parent is None else spans[parent], 1)
        s.start_ns, s.end_ns, s.counters = t0 * MS, t1 * MS, dict(counters)
        spans.append(s)
    return spans


def read(run):
    return load_module("metrics", "sort_passes_per_job").read(run)


def test_reads_the_passes_per_traced_job(monkeypatch):
    monkeypatch.setattr(trace, "session", _session)
    assert read(RUN) == pytest.approx(7.0, rel=1e-12)


def test_silent_untraced_or_with_nothing_counted(monkeypatch):
    monkeypatch.setattr(trace, "session", _session)
    assert read({**RUN, "trace": None}) is None
    monkeypatch.setattr(trace, "session", lambda: [])
    assert read(RUN) is None
    root = _session()[0]
    root.counters = {"records": 4096}
    monkeypatch.setattr(trace, "session", lambda: [root])
    assert read(RUN) is None


def test_silent_where_the_program_has_no_tracer(monkeypatch):
    monkeypatch.setitem(sys.modules, "ibu_tpu_torch.utils.trace", None)
    assert read(RUN) is None


def test_declared_for_the_sort_cell():
    metric = next(m for m in bench()["per_layer"] if m["name"] == "sort_passes_per_job")
    assert metric == {"name": "sort_passes_per_job", "unit": "passes", "better": "lower",
                      "source": "program_counter", "layer": "sort (ops/stats.py sort_records)",
                      "moves": "kernel_ms_per_mrecord", "workloads": ["dropseq.sort"]}


@pytest.mark.cuda
def test_a_traced_sort_run_on_the_card_reads_seven_passes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result, _ = run_small("dropseq.sort", trace=True, seconds=1.0, device="cuda")
    assert result["correct"]
    assert result["metrics"]["sort_passes_per_job"]["value"] == 7.0
