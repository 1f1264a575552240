"""``hist_sort_passes_per_job``: the program's ``hist_sort_passes`` counter
over the traced jobs, on a synthetic session; silent where the run is
untraced, where nothing was counted and where the program has no tracer;
and a traced run of the Drop-seq histogram cell on the card, where each
batch launches 4 passes (a 32-bit bound) and each merge 8 or more."""

from __future__ import annotations

import sys

import pytest
import torch

from _small import bench, run_small

from portbench.harness import load_module

from ibu_tpu_torch.utils import trace

MS = 1_000_000
RUN = {"window": {"job_s": [0.05, 0.05], "records": 2 * 4096, "wall_s": 0.1},
       "setup_s": 1.0, "trace": {"jobs_s": 0.1}, "card": None}


def _session() -> list:
    """Two histogram calls: three batches of 4 passes and two merges of 8,
    the second inside its update; (name, parent index, start ms, end ms,
    counters)."""
    rows = [("ibu.stream_file_histogram", None, 0, 5, {"records": 4096}),
            ("hist.update", 0, 1, 2, {"hist_sort_passes": 4}),
            ("hist.update", 0, 2, 3, {"hist_sort_passes": 4}),
            ("hist.merge", 0, 3, 4, {"hist_sort_passes": 8}),
            ("ibu.stream_file_histogram", None, 5, 10, {"records": 4096}),
            ("hist.update", 4, 6, 8, {"hist_sort_passes": 4}),
            ("hist.merge", 5, 7, 8, {"hist_sort_passes": 8})]
    spans = []
    for name, parent, t0, t1, counters in rows:
        s = trace.Span(name, len(spans), None if parent is None else spans[parent], 1)
        s.start_ns, s.end_ns, s.counters = t0 * MS, t1 * MS, dict(counters)
        spans.append(s)
    return spans


def read(run):
    return load_module("metrics", "hist_sort_passes_per_job").read(run)


def test_reads_the_passes_per_traced_job(monkeypatch):
    monkeypatch.setattr(trace, "session", _session)
    assert read(RUN) == pytest.approx(14.0, rel=1e-12)  # 28 passes over 2 jobs


def test_silent_untraced_or_with_nothing_counted(monkeypatch):
    monkeypatch.setattr(trace, "session", _session)
    assert read({**RUN, "trace": None}) is None
    monkeypatch.setattr(trace, "session", lambda: [])
    assert read(RUN) is None
    root = _session()[0]
    monkeypatch.setattr(trace, "session", lambda: [root])
    assert read(RUN) is None


def test_silent_where_the_program_has_no_tracer(monkeypatch):
    monkeypatch.setitem(sys.modules, "ibu_tpu_torch.utils.trace", None)
    assert read(RUN) is None


def test_declared_for_the_histogram_cells():
    metric = next(m for m in bench()["per_layer"] if m["name"] == "hist_sort_passes_per_job")
    assert metric == {"name": "hist_sort_passes_per_job", "unit": "passes", "better": "lower",
                      "source": "program_counter",
                      "layer": "histogram engine (parallel/device.py DeviceHistogram)",
                      "moves": "kernel_ms_per_mrecord",
                      "workloads": ["dropseq.histogram", "splitseq.histogram"]}


def test_a_traced_cpu_run_counts_no_pass():
    """The CPU runs the plain version, which launches no pass."""
    result, _ = run_small("dropseq.histogram", trace=True)
    assert result["correct"] and "hist_sort_passes_per_job" not in result["metrics"]


@pytest.mark.cuda
def test_a_traced_histogram_run_on_the_card_counts_the_passes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result, _ = run_small("dropseq.histogram", trace=True, seconds=1.0, device="cuda")
    assert result["correct"]
    # 60,000 reads in 8 batches of 8192 (4 passes each) and one merge of
    # ceil((1 + 32 + 16) / 8) = 7 passes
    assert result["metrics"]["hist_sort_passes_per_job"]["value"] == 8 * 4 + 7
