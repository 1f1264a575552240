"""The five metrics read from the program's own spans and counters
(:mod:`ibu_tpu_torch.utils.trace`): each on a synthetic session, each
silent where the run is untraced, where nothing was recorded and where the
program has no tracer (as before it had one), and a traced run of a small
cell reporting those its device allows."""

from __future__ import annotations

import json
import sys

import pytest
import torch

from _small import SEED, SMALL, bench, run_small

from portbench import harness
from portbench.harness import cell_metrics, load_module

from ibu_tpu_torch.utils import trace

MS = 1_000_000
#: metric → its reading of :func:`_session` and :data:`RUN`
EXPECTED = {
    "host_stage_gbps": 4.0,  # 4e6 B over 1 ms of h2d.stage
    "pinned_alloc_ms_per_job": 1.0,  # 2 ms over 2 jobs
    "host_wait_pct": 4.0,  # 3 + 1 ms of 100 ms of jobs
    "hist_issue_ms_per_batch": 1.5,  # self times 2 and 1 ms
    "link_bytes_per_record": 30.0,  # 36,000 + 24,000 B over 2,000 records
}
RUN = {"window": {"job_s": [0.05, 0.05], "records": 2000, "wall_s": 0.1},
       "setup_s": 1.0, "trace": {"jobs_s": 0.1}, "card": None}


def _session() -> list:
    """One call: (name, parent index, start ms, end ms, counters)."""
    rows = [("ibu.call", None, 0, 20, {"records": 1000, "h2d_bytes": 36000}),
            ("h2d.pinned_alloc", 0, 0, 2, {}),
            ("h2d.stage", 0, 2, 3, {"staged_bytes": 4_000_000}),
            ("d2h.wait", 0, 3, 6, {"d2h_bytes": 24000}),
            ("stream.slot_wait", 0, 6, 7, {}),
            ("hist.update", 0, 7, 12, {}),
            ("hist.merge", 5, 8, 11, {}),
            ("hist.update", 0, 12, 13, {})]
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
def test_silent_untraced_or_with_nothing_recorded(name, monkeypatch):
    read = load_module("metrics", name).read
    monkeypatch.setattr(trace, "session", _session)
    assert read({**RUN, "trace": None}) is None
    monkeypatch.setattr(trace, "session", lambda: [])
    assert read(RUN) is None
    root = _session()[0]
    root.counters = {"records": 1000}
    monkeypatch.setattr(trace, "session", lambda: [root])
    assert read(RUN) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_silent_where_the_program_has_no_tracer(name, monkeypatch):
    monkeypatch.setitem(sys.modules, "ibu_tpu_torch.utils.trace", None)
    assert load_module("metrics", name).read(RUN) is None


def test_every_program_metric_is_in_the_benchmark():
    per_layer = {m["name"]: m for m in bench()["per_layer"]}
    for name in EXPECTED:
        assert per_layer[name]["source"] in ("program_span", "program_counter")
        assert per_layer[name]["moves"] == "kernel_ms_per_mrecord"
    assert per_layer["hist_issue_ms_per_batch"]["workloads"] == ["dropseq.histogram"]


def test_a_traced_cpu_run_reports_what_the_cpu_allows(capsys):
    """On the CPU no copy crosses a link, so only the histogram's issue time
    reads; the others stay silent, as a program without spans leaves them."""
    args = harness.parse_args(["--workload", "dropseq.histogram", "--seed", str(SEED),
                               "--seconds", "0.3", "--trace", "1"])
    rc = harness.run_and_report(bench(), args, torch.device("cpu"), 0.0, sizes=SMALL)
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and result["correct"]
    assert result["metrics"]["hist_issue_ms_per_batch"]["value"] > 0
    assert not set(EXPECTED) - {"hist_issue_ms_per_batch"} & set(result["metrics"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["v3.roundtrip", "v3.stream_stats", "dropseq.sort",
                                  "dropseq.histogram"])
def test_a_traced_run_on_the_card_reports_each_program_metric_it_names(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result, _ = run_small(cell, trace=True, seconds=1.0, device="cuda")
    named = {m["name"] for m in cell_metrics(bench(), cell, True)} & set(EXPECTED)
    assert result["correct"] and named <= set(result["metrics"])
    assert all(result["metrics"][name]["value"] > 0 for name in named)
