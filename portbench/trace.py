"""The traced run's summary, reduced from a ``torch.profiler`` Chrome trace.

Only the benchmark's own spans are in the trace (``torch.profiler.record_function``
around each job, named ``job``, and around each call into a layer of the
program) beside what the profiler records itself: the host's aten operators
and the card's kernels, memcpys and memsets. Times are the trace's
microseconds on the host's clock, to which the profiler aligns the card's.

A device operation belongs to the job whose span holds its start; every job
ends in a synchronise, so its device work lies inside its span.

An untraced run records the card alone (``ProfilerActivity.CUDA``) over its
whole window, for :func:`card_time`: the window starts after a synchronise
and ends with one, so every device operation in that trace is its jobs'.
"""

from __future__ import annotations

import json
from collections import defaultdict

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
JOB_SPAN = "job"
TOP = 10
NAME_CHARS = 120


def _union(starts: np.ndarray, ends: np.ndarray) -> list[tuple[float, float]]:
    """Merged intervals of ``[starts[i], ends[i])``, in order."""
    out: list[list[float]] = []
    for s, e in sorted(zip(starts.tolist(), ends.tolist())):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _memcpy_bytes(ev: dict) -> float:
    args = ev.get("args", {})
    if "bytes" in args:
        return float(args["bytes"])
    gbps = args.get("memory bandwidth (GB/s)")
    return float(gbps) * float(ev["dur"]) * 1e3 if gbps is not None else float("nan")


def _innermost_labels(host: list[dict], points: list[float]) -> list[str]:
    """For each of ``points`` (ascending), the label of what the host was in:
    the innermost benchmark span, and under it the innermost aten operator
    if there is one (``"encode_batch/aten::copy_"``). Host events of one
    thread nest, so one sweep with a stack finds them."""
    events = sorted(host, key=lambda e: (e["ts"], -e["dur"]))
    stack: list[dict] = []
    labels, k = [], 0
    for t in points:
        while k < len(events) and events[k]["ts"] <= t:
            ev = events[k]
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= ev["ts"]:
                stack.pop()
            stack.append(ev)
            k += 1
        while stack and stack[-1]["ts"] + stack[-1]["dur"] < t:
            stack.pop()
        span = next((e["name"] for e in reversed(stack) if e["cat"] == "user_annotation"
                     and e["name"] != JOB_SPAN), None)
        op = stack[-1]["name"] if stack and stack[-1]["cat"] == "cpu_op" else None
        label = "/".join(x for x in (span or JOB_SPAN, op) if x)
        labels.append(label)
    return labels


def _events(path: str) -> list[dict]:
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def card_time(path: str) -> dict:
    """The card's time over the trace at ``path``: ``busy_s``, the union of
    every kernel, memcpy and memset on any stream, and ``kernel_s``, the
    union of the kernels alone."""
    dev = [e for e in _events(path) if e.get("cat") in DEVICE_CATS]

    def union_s(evs: list[dict]) -> float:
        ds = np.array([e["ts"] for e in evs], dtype=np.float64)
        de = ds + np.array([e["dur"] for e in evs], dtype=np.float64)
        return sum(e - s for s, e in _union(ds, de)) / 1e6

    return {"busy_s": union_s(dev),
            "kernel_s": union_s([e for e in dev if e["cat"] == "kernel"])}


def summarize(path: str) -> dict:
    """Reduce the trace at ``path``: the jobs' spans, the device's busy and
    kernel time inside them, the host→device copies, and the breakdown (the
    device operations that took most time, and the idle time inside the
    jobs by what the host was doing)."""
    events = _events(path)
    jobs = sorted((e for e in events if e.get("cat") == "user_annotation"
                   and e["name"] == JOB_SPAN), key=lambda e: e["ts"])
    if not jobs:
        raise ValueError(f"{path}: no '{JOB_SPAN}' span in the trace")
    tid = jobs[0]["tid"]
    js = np.array([e["ts"] for e in jobs], dtype=np.float64)
    je = np.array([e["ts"] + e["dur"] for e in jobs], dtype=np.float64)
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    ds = np.array([e["ts"] for e in dev], dtype=np.float64)
    de = ds + np.array([e["dur"] for e in dev], dtype=np.float64)
    owner = np.searchsorted(js, ds, side="right") - 1
    inside = (owner >= 0) & (ds < je[np.maximum(owner, 0)])
    de_clip = np.where(inside, np.minimum(de, je[np.maximum(owner, 0)]), de)

    w0, w1 = float(js[0]), float(je[-1])
    in_window = (ds < w1) & (de > w0)
    busy_window = _union(np.maximum(ds[in_window], w0), np.minimum(de[in_window], w1))
    busy_jobs = _union(ds[inside], de_clip[inside])

    kernel_us = sum(float(de_clip[i] - ds[i]) for i in np.flatnonzero(inside)
                    if dev[i]["cat"] == "kernel")
    h2d = [i for i in np.flatnonzero(inside)
           if dev[i]["cat"] == "gpu_memcpy" and "HtoD" in dev[i]["name"]]
    per_op: dict[str, float] = defaultdict(float)
    for i in np.flatnonzero(inside):
        per_op[dev[i]["name"][:NAME_CHARS]] += float(de_clip[i] - ds[i]) / 1e6

    # idle stretches inside the jobs, named by what the host was in
    gaps: list[tuple[float, float]] = []
    b = 0
    for s, e in zip(js.tolist(), je.tolist()):
        t = s
        while b < len(busy_jobs) and busy_jobs[b][0] < e:
            bs, be = busy_jobs[b]
            if bs > t:
                gaps.append((t, bs))
            t = max(t, be)
            b += 1
        if t < e:
            gaps.append((t, e))
    host = [e for e in events if e.get("tid") == tid and e.get("cat") in ("cpu_op", "user_annotation")]
    labels = _innermost_labels(host, [(s + e) / 2 for s, e in gaps])
    idle: dict[str, float] = defaultdict(float)
    for (s, e), label in zip(gaps, labels):
        idle[label] += (e - s) / 1e6

    def top(d: dict[str, float]) -> list[list]:
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {
        "jobs": list(zip(js.tolist(), je.tolist())),
        "jobs_s": float((je - js).sum()) / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "busy_s": sum(e - s for s, e in busy_window) / 1e6,
        "busy_in_jobs_s": sum(e - s for s, e in busy_jobs) / 1e6,
        "kernel_s": kernel_us / 1e6,
        "h2d_bytes": sum(_memcpy_bytes(dev[i]) for i in h2d),
        "h2d_s": sum(float(de_clip[i] - ds[i]) for i in h2d) / 1e6,
        "device_ops": top(per_op),
        "idle_gaps": top(idle),
    }
