"""The benchmark's harness: one run of one cell.

It reads ``BENCHMARK.json`` at the root of the checkout and finds
everything of the cell by name: the configuration's file, the traffic file
``traffic/<traffic>.json``, the cell's own file ``workloads/<cell>.json``,
the job module ``jobs/<job>.py`` the traffic names and each metric's module
``metrics/<metric>.py``. Adding a cell, a configuration, a traffic mix or a
metric is adding files and entries; nothing here names one.

A run makes its inputs from the seed, warms the job up, then runs it back to
back for the window, a closed loop with one client. With ``--trace 1`` it
runs the window under ``torch.profiler`` for at most :data:`TRACE_SECONDS`
and reports the per-layer metrics; otherwise the end-to-end ones, with the
card alone recorded over the whole window for its busy time. After the
window it frees the program's memory, runs the plain reference on the same
inputs and compares what the jobs returned. The last line of standard
output is the result's JSON; the numbers compared, each beside its limit,
are the last lines of standard error and the last key of the result. A
process that holds JAX or the JAX package by then prints no result.

A cell of more than one card (its ``chips``) runs one rank a card, each in
a process of its own: :mod:`portbench.ranks`, which the run of a one-card
cell never loads.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import shutil
import sys
import tempfile
import time
import traceback
from collections import deque
from pathlib import Path

import numpy as np
import torch

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
#: top-level module names the process may not hold once the window closed
FORBIDDEN = ("jax", "jaxlib", "flax", "ibu_tpu")
#: the longest traced window
TRACE_SECONDS = 5.0


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` of the benchmark, by name."""
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {path}")
    key = f"portbench_{kind}_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_spec(bench: dict, cell: str) -> dict:
    """The cell's entry, its configuration and its parameters: the traffic
    file's, then the cell file's over them."""
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    params = load_json(BENCH_DIR / "traffic" / f"{entry['traffic']}.json")
    params.update(load_json(BENCH_DIR / "workloads" / f"{cell}.json"))
    return {"entry": entry, "cfg": load_json(ROOT / config["file"]), "params": params}


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: the per-layer ones when traced,
    else the end-to-end ones; each where it names the cell or names none."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


def cards_used() -> int:
    """The CUDA cards on which the run allocated memory."""
    return sum(torch.cuda.max_memory_allocated(i) > 0 for i in range(torch.cuda.device_count()))


def forbidden_modules() -> list[str]:
    """Top-level names of :data:`FORBIDDEN` that ``sys.modules`` holds,
    compared whole (``ibu_tpu_torch`` is not ``ibu_tpu``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


class Keeper:
    """The outputs compared after the window: the last ``last`` jobs (with
    ``last`` the number of distinct inputs, every input once) and a uniform
    sample of ``sampled`` of the others, drawn from the seed (reservoir
    sampling); every output where ``sampled`` is None."""

    def __init__(self, seed: int, sampled: int | None, last: int):
        from portbench.traffic.generate import rng_for

        self.rng = rng_for(seed, 1)
        self.sampled = sampled
        self.reservoir: list = []
        self.recent: deque = deque(maxlen=last)
        self.seen = 0

    def add(self, i: int, out) -> None:
        if self.sampled is None:
            self.reservoir.append((i, out))
            return
        if len(self.recent) == self.recent.maxlen:
            old = self.recent[0]
            if len(self.reservoir) < self.sampled:
                self.reservoir.append(old)
            else:
                j = int(self.rng.integers(0, self.seen + 1))
                if j < self.sampled:
                    self.reservoir[j] = old
            self.seen += 1
        self.recent.append((i, out))

    def kept(self) -> list:
        return sorted(self.reservoir + list(self.recent), key=lambda p: p[0])


def _sync(device: torch.device):
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def timed_window(job, state: dict, seconds: float, keeper: Keeper, sync) -> dict:
    """Jobs back to back until ``seconds`` have passed; no job starts after."""
    job_s, records, attempted, failed = [], 0, 0, 0
    sync()
    start = time.perf_counter()
    end, deadline, i = start, start + seconds, 0
    while time.perf_counter() < deadline:
        t0 = time.perf_counter()
        attempted += 1
        try:
            with state["span"]("job"):
                out = job.run(state, i)
                sync()
        except Exception:
            failed += 1
            traceback.print_exc()
            break
        end = time.perf_counter()
        job_s.append(end - t0)
        records += state["records_per_job"]
        keeper.add(i, out)
        i += 1
    return {"job_s": job_s, "records": records, "wall_s": end - start,
            "attempted": attempted, "failed": failed}


def _null_span(name: str):
    return contextlib.nullcontext()


class ForbiddenModules(RuntimeError):
    """A process of the run held modules of :data:`FORBIDDEN` after the
    window: ``found`` names each with the rank that held it."""

    def __init__(self, found: list[str]):
        super().__init__(", ".join(found))
        self.found = found


def warm_up(job, state: dict, sampled: int | None, sync) -> None:
    """Every distinct input once, holding as many outputs as the window
    keeps, so that the caching allocators hold what it needs."""
    held = []
    for i in range((sampled or 0) + state["distinct"] + 1):
        held.append(job.run(state, i))
        sync()
    del held


def measure_window(job, state: dict, seconds: float, trace: bool, keeper: Keeper, sync,
                   workdir: str, job_name: str) -> tuple[dict, dict | None, dict | None]:
    """The timed window: traced for at most :data:`TRACE_SECONDS` under
    ``torch.profiler`` (CPU and CUDA), else the card alone recorded over the
    whole window. Returns the window, the traced summary and the card's
    reading (each None where not taken)."""
    from torch.profiler import ProfilerActivity, profile

    from portbench import trace as trace_mod

    device = state["device"]
    summary, card = None, None
    if trace:
        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            window = timed_window(job, state, min(seconds, TRACE_SECONDS), keeper, sync)
        trace_path = str(Path(workdir) / "trace.json")
        prof.export_chrome_trace(trace_path)
        del prof
        summary = trace_mod.summarize(trace_path)
        summary.update(job=job_name, records_per_job=state["records_per_job"],
                       bc_len=state["bc_len"], umi_len=state["umi_len"])
    elif device.type == "cuda":
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            window = timed_window(job, state, seconds, keeper, sync)
        card_path = str(Path(workdir) / "card.json")
        prof.export_chrome_trace(card_path)
        del prof
        card = trace_mod.card_time(card_path)
    else:
        window = timed_window(job, state, seconds, keeper, sync)
    return window, summary, card


def compare_kept(job, state: dict, kept: list) -> tuple[dict, float]:
    """The plain reference worked out again, and the job's numbers over the
    kept outputs, each ``(value, limit)``; and the seconds that took."""
    limits = job.LIMITS
    t_ref = time.perf_counter()
    found = job.compare(state, job.reference(state), kept)
    reference_s = time.perf_counter() - t_ref
    checks = {name: (found[name], limits[name]) for name in limits}
    checks["jobs_compared"] = (len(kept), None)
    return checks, reference_s


def run_cell(bench: dict, cell: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float,
             sizes: dict | None = None) -> tuple[dict, dict]:
    """One run of ``cell``; returns the result and the checks, each
    ``{name: (value, limit)}``. ``t_start`` is the process's start on
    ``time.perf_counter``'s clock. ``sizes`` (tests only) replaces entries
    of the configuration (``"cfg"``) and of the parameters (``"params"``)."""
    spec = cell_spec(bench, cell)
    cfg = {**spec["cfg"], **(sizes or {}).get("cfg", {})}
    params = {**spec["params"], **(sizes or {}).get("params", {})}
    if spec["entry"]["chips"] > 1:
        from portbench.ranks import run_cell as run_ranks

        return run_ranks(bench, cell, seed, seconds, trace, device, t_start, cfg, params,
                         spec["entry"]["chips"])
    job = load_module("jobs", params["job"])
    sync = _sync(device)
    workdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        state = job.prepare({"cfg": cfg, "params": params, "seed": seed, "cell": cell,
                             "workdir": workdir})
        state["device"] = device
        state["span"] = torch.profiler.record_function if trace else _null_span
        sampled = params.get("sampled_jobs")
        keeper = Keeper(seed, sampled, state["distinct"])
        warm_up(job, state, sampled, sync)
        # what set-up made lives on: a full collection in the window skips it
        gc.collect()
        gc.freeze()
        setup_s = time.perf_counter() - t_start

        window, summary, card = measure_window(job, state, seconds, trace, keeper, sync,
                                               workdir, params["job"])

        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        kept = keeper.kept()
        del keeper
        gc.unfreeze()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        checks, reference_s = compare_kept(job, state, kept)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    device_info = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": cards_used() if device.type == "cuda" else 1,
        "memory_peak_bytes": int(peak),
    }
    if summary is not None:
        device_info.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
    run = {"window": window, "setup_s": setup_s, "trace": summary, "card": card}
    return report(bench, cell, seed, trace, run, kept, checks, device_info, reference_s)


def report(bench: dict, cell: str, seed: int, trace: bool, run: dict, kept: list,
           checks: dict, device_info: dict, reference_s: float) -> tuple[dict, dict]:
    """The result's line from the run's record (``window``, ``setup_s``,
    ``trace``, ``card``): the cell's metrics, each read by its module, the
    verdict and the device; the job times on standard error."""
    window, summary, card, setup_s = run["window"], run["trace"], run["card"], run["setup_s"]
    metrics = {}
    for m in cell_metrics(bench, cell, trace):
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = (window["failed"] == 0 and len(kept) > 0
               and all(v <= lim for v, lim in checks.values() if lim is not None))
    result = {"correct": bool(correct), "attempted": window["attempted"],
              "failed": window["failed"], "metrics": metrics, "device": device_info}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    times = np.array(window["job_s"]) * 1e3
    if len(times):
        q = np.percentile(times, [50, 90, 95, 99])
        print(f"portbench {cell} seed={seed} trace={int(trace)} jobs={len(times)} "
              f"wall_s={window['wall_s']:.3f} setup_s={setup_s:.3f} job_ms p50={q[0]:.3f} "
              f"p90={q[1]:.3f} p95={q[2]:.3f} p99={q[3]:.3f} min={times.min():.3f} "
              f"max={times.max():.3f} over_2x_p50={int((times > 2 * q[0]).sum())} "
              f"reference_s={reference_s:.3f}"
              + ("" if card is None else f" card_busy_s={card['busy_s']:.6f} "
                 f"card_kernel_s={card['kernel_s']:.6f}"), file=sys.stderr)
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result, checks


def parse_args(argv: list[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark.")
    ap.add_argument("--workload", required=True, help="the cell's name in BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="length of the window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv: list[str], t_start: float) -> int:
    args = parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    chips = cell_spec(bench, args.workload)["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA card(s), this machine has {found}",
              file=sys.stderr)
        return 2
    return run_and_report(bench, args, torch.device("cuda", 0), t_start)


def run_and_report(bench: dict, args: argparse.Namespace, device: torch.device,
                   t_start: float, sizes: dict | None = None) -> int:
    """Run the cell, then print the numbers compared and the result's line,
    unless the process holds a module of :data:`FORBIDDEN` by then: the
    look comes after every part of the run (the reference, the comparison,
    the metrics' readers) has been loaded and has run."""
    try:
        result, checks = run_cell(bench, args.workload, args.seed, args.seconds,
                                  bool(args.trace), device, t_start, sizes)
        present = forbidden_modules()
    except ForbiddenModules as e:
        present = e.found
    if present:
        print(f"portbench: the process holds {', '.join(present)} after the window; "
              "no result", file=sys.stderr)
        return 3
    for name, (value, limit) in checks.items():
        verdict = "" if limit is None else (" ok" if value <= limit else " FAIL")
        bound = "" if limit is None else f" limit {limit}"
        print(f"check {name} {value}{bound}{verdict}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
