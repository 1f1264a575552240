"""The run's refusals: no card, no program beside the benchmark."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import types

import pytest
import torch

from _small import ROOT, SEED, SMALL, bench, run_small

from portbench import harness


def test_no_card_exits_nonzero_and_prints_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "dropseq.sort", "--seed", str(SEED), "--seconds", "1"], 0.0)
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA card" in out.err


def test_too_few_cards_exit_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    rc = harness.main(["--workload", "v3.roundtrip", "--seed", "1", "--seconds", "1"], 0.0)
    assert rc != 0 and capsys.readouterr().out == ""


def test_alone_in_a_directory_it_exits_nonzero(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "dropseq.sort",
                          "--seed", "5", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_result_line_has_the_contract_keys():
    result, _ = run_small("dropseq.sort", trace=True)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks" and set(result) <= {
        "correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"}
    assert {"platform", "kind", "count", "memory_peak_bytes", "busy_s", "window_s"} <= set(result["device"])
    assert all(len(result["breakdown"][k]) <= 10 for k in ("device_ops", "idle_gaps"))
    json.dumps(result)


def _load_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))


def _importing_jax(module, fn: str, monkeypatch):
    real = getattr(module, fn)

    def wrapped(*a, **k):
        _load_jax(monkeypatch)
        return real(*a, **k)

    setattr(module, fn, wrapped)
    return module


@pytest.mark.parametrize("where", ["before_the_run", "in_the_reference", "in_a_metric"])
def test_a_process_that_holds_jax_prints_no_result(where, monkeypatch, capsys):
    """JAX loaded at any point of a run, the last metric's reader included,
    leaves the run with exit code 3 and nothing on standard output."""
    real_load = harness.load_module

    def load(kind, name):
        module = real_load(kind, name)
        if kind == "jobs" and where == "in_the_reference":
            return _importing_jax(module, "reference", monkeypatch)
        if kind == "metrics" and where == "in_a_metric" and name == "setup_s":
            return _importing_jax(module, "read", monkeypatch)
        return module

    if where == "before_the_run":
        _load_jax(monkeypatch)
    monkeypatch.setattr(harness, "load_module", load)
    args = harness.parse_args(["--workload", "v3.stream_stats", "--seed", str(SEED),
                               "--seconds", "0.1"])
    rc = harness.run_and_report(bench(), args, torch.device("cpu"), 0.0, sizes=SMALL)
    out = capsys.readouterr()
    assert rc == 3 and out.out == "" and "jax" in out.err


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["v3.roundtrip", "v3.stream_stats", "dropseq.sort",
                                  "dropseq.histogram"])
def test_a_small_untraced_run_on_the_card_reports_every_end_to_end_metric(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result, _ = run_small(cell, seconds=1.0, device="cuda")
    assert result["correct"] and result["device"]["count"] == 1
    assert set(result["metrics"]) == {m["name"] for m in harness.cell_metrics(bench(), cell, False)}
    assert all(m["value"] > 0 for m in result["metrics"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["v3.roundtrip", "v3.stream_stats", "dropseq.sort",
                                  "dropseq.histogram"])
def test_a_small_traced_run_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result, _ = run_small(cell, trace=True, seconds=1.0, device="cuda")
    assert result["correct"] and result["device"]["busy_s"] > 0
    assert result["device"]["count"] == 1
    for name, m in result["metrics"].items():
        assert m["value"] is not None
        if name.endswith("_pct"):
            assert 0 <= m["value"] <= 100
