"""The byte models against hand counts, and the trace's reduction: a share
comes from all kernels inside the jobs' spans, whatever their names."""

from __future__ import annotations

import json

import pytest

import _small  # noqa: F401

from portbench import roofline, trace
from portbench.harness import load_module


@pytest.mark.parametrize("job, widths, per_record", [
    ("roundtrip", (16, 12), 120),  # 16 + 12 + 8 in and 24 out, both ways
    ("roundtrip", (12, 8), 104),
    ("stream_stats", (16, 12), 24),
    ("sort", (12, 8), 48),
    ("histogram", (12, 8), 8),
])
def test_byte_models(job, widths, per_record):
    assert roofline.JOB_BYTES[job](1000, *widths) == 1000 * per_record


def test_peak_is_the_h100_sxm_figure():
    assert roofline.PEAK_GBPS == 3350.0


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": args}


def _write_trace(tmp_path):
    events = [
        _ev("user_annotation", "job", 0, 100), _ev("user_annotation", "sort_batch", 1, 98),
        _ev("cpu_op", "aten::copy_", 2, 8),
        _ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 5, 10, tid=7, bytes=500_000),
        _ev("kernel", "any_name_at_all", 20, 10, tid=7),
        _ev("kernel", "void other<int>(x)", 35, 5, tid=7),
        _ev("gpu_memset", "Memset (Device)", 40, 2, tid=7),
        _ev("user_annotation", "job", 200, 100), _ev("user_annotation", "sort_batch", 201, 98),
        _ev("kernel", "third", 210, 20, tid=7),
        _ev("kernel", "outside_every_job", 150, 30, tid=7),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return path


def test_summary_reads_every_kernel_in_the_spans(tmp_path):
    s = trace.summarize(str(_write_trace(tmp_path)))
    assert s["jobs"] == [(0.0, 100.0), (200.0, 300.0)]
    assert s["kernel_s"] == pytest.approx(35e-6)  # 10 + 5 + 20, not the one outside
    assert s["busy_in_jobs_s"] == pytest.approx(47e-6)  # 10 + 10 + 5 + 2 + 20
    assert s["busy_s"] == pytest.approx(77e-6)  # and the 30 between the jobs
    assert s["window_s"] == pytest.approx(300e-6) and s["jobs_s"] == pytest.approx(200e-6)
    assert s["h2d_bytes"] == 500_000 and s["h2d_s"] == pytest.approx(10e-6)
    labels = dict(s["idle_gaps"])
    # gaps 0-5 (the host in the copy), 15-20, 30-35, 42-100, 200-210, 230-300
    assert labels["sort_batch/aten::copy_"] == pytest.approx(5e-6)
    assert labels["sort_batch"] == pytest.approx((5 + 5 + 58 + 10 + 70) * 1e-6)


def test_share_is_bytes_over_all_kernel_time(tmp_path):
    s = trace.summarize(str(_write_trace(tmp_path)))
    s.update(job="sort", records_per_job=1000, bc_len=12, umi_len=8)
    want = 100 * (2 * 1000 * 48) / 35e-6 / 3350e9
    assert roofline.job_share_pct(s, "sort") == pytest.approx(want)
    assert roofline.job_share_pct(s, "histogram") is None
    run = {"trace": s, "window": {}, "setup_s": 0}
    assert load_module("metrics", "sort_roofline_pct").read(run) == pytest.approx(want)
    assert load_module("metrics", "codec_roofline_pct").read(run) is None
    assert load_module("metrics", "h2d_gbps").read(run) == pytest.approx(50.0)
    assert load_module("metrics", "device_idle_pct").read(run) == pytest.approx(100 * (1 - 47 / 200))


def test_card_time_is_the_union_of_every_device_operation_in_the_trace(tmp_path):
    path = _write_trace(tmp_path)
    card = trace.card_time(str(path))
    # 5-15 copy, 20-30 and 35-40 kernels, 40-42 memset, 210-230, 150-180
    assert card["busy_s"] == pytest.approx(77e-6)
    assert card["kernel_s"] == pytest.approx(65e-6)
    run = {"card": card, "window": {"records": 2000, "wall_s": 1.0}, "trace": None}
    assert load_module("metrics", "kernel_ms_per_mrecord").read(run) == pytest.approx(65e-3 / 2e-3)
    assert load_module("metrics", "wall_records_per_s").read(run) == pytest.approx(2000)
    unread = {"card": None, "window": {"records": 2000, "wall_s": 1.0}, "trace": None}
    assert load_module("metrics", "kernel_ms_per_mrecord").read(unread) is None
    no_kernel = {**run, "card": {"busy_s": 1e-3, "kernel_s": 0.0}}
    assert load_module("metrics", "kernel_ms_per_mrecord").read(no_kernel) is None


def test_renaming_kernels_leaves_the_share(tmp_path):
    path = _write_trace(tmp_path)
    data = json.loads(path.read_text())
    for e in data["traceEvents"]:
        if e["cat"] == "kernel":
            e["name"] = "renamed_" + e["name"]
    path.write_text(json.dumps(data))
    renamed = trace.summarize(str(path))
    assert renamed["kernel_s"] == pytest.approx(35e-6)
