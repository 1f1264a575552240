"""Cells whose ranks run in processes of their own.

A cell of ``P`` > 1 ranks (its ``chips``) runs one rank a process. The harness's process is rank 0, on card 0, and starts a
worker for each other rank, ``python portbench/ranks.py``, which takes card
``r`` (modulo the cards there are, as the program's ``init_distributed``
sets it). Every rank joins one cohort with
``ibu_tpu_torch.parallel.multihost.init_distributed`` at a ``file://`` store
in the run's working directory, and makes its own state with the job
module's ``prepare`` (``ctx["rank"]``, ``ctx["ranks"]``), rank 0 first.

Rank 0 drives the workers over a socket pair each. A job is a command to
every worker; every rank then runs the job module's ``run(state, i)`` on
its card and synchronises it, and the job ends when the last rank has
answered. The warm-up, the closed loop and the window are the harness's
(:func:`portbench.harness.timed_window`). Rank 0 starts and stops the
workers' profilers with the window: each records its card alone untraced
and CPU and CUDA traced, and reduces its own trace as rank 0 does. After
the window each worker returns its cards (identity and peak), its
readings, its call times (its own clock around ``run``) and its outputs of
the kept jobs, chosen by a :class:`~portbench.harness.Keeper` like rank 0's.

The run reports as ``device.count`` the distinct cards on which any rank
allocated memory (two ranks on one card count once) and as
``memory_peak_bytes`` the fullest card's peak. An untraced run's card
reading is every rank's kernel and busy time summed, over the records of
every rank; a traced run's summary is rank 0's, over rank 0's records, and
every rank's is in the run's ``ranks``, with each traced job's time from
the rank's call into the program to its entry into the merge
(:func:`portbench.trace.collective_offsets`). The job's ``compare`` gets each
kept job as ``(i, [output of rank 0, of rank 1, ...])``, None for a rank
that returned none.

A worker that dies, raises or does not answer within its deadline fails the
job: every worker is killed at once, which ends any collective rank 0 waits
in, and the run goes on to its result with ``correct`` false. No worker
outlives the run.
"""

from __future__ import annotations

import argparse
import gc
import queue
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from multiprocessing.connection import Connection, wait
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import harness  # noqa: E402

#: seconds a worker has to answer a command of the window
DEADLINE_S = 120.0
#: seconds a worker has to answer a command of set-up, whose first job may
#: build the program's kernels
SETUP_DEADLINE_S = 1200.0
#: seconds a worker has to end once it has said goodbye
EXIT_S = 30.0


class RankFailure(RuntimeError):
    """A worker died, raised or missed its deadline."""


def card_peaks() -> list[tuple[str, int]]:
    """``(identity, peak bytes)`` of each CUDA card on which this process
    allocated memory; the identity is the card's UUID."""
    if not torch.cuda.is_available():
        return []
    peaks = [(i, torch.cuda.max_memory_allocated(i)) for i in range(torch.cuda.device_count())]
    return [(str(torch.cuda.get_device_properties(i).uuid), int(peak))
            for i, peak in peaks if peak > 0]


def count_cards(ranks_cards: list[list[tuple[str, int]]]) -> tuple[int, int]:
    """The distinct cards in every rank's :func:`card_peaks`, and the
    fullest card's bytes, the peaks of ranks that share a card added."""
    per_card: dict[str, int] = {}
    for cards in ranks_cards:
        for identity, peak in cards:
            per_card[identity] = per_card.get(identity, 0) + peak
    return len(per_card), max(per_card.values(), default=0)


def summed_card(readings: list[dict | None]) -> dict | None:
    """Every rank's card reading (:func:`portbench.trace.card_time`) summed:
    card-seconds over all ranks; None where a rank has none."""
    if not readings or any(r is None for r in readings):
        return None
    return {k: sum(r[k] for r in readings) for k in ("busy_s", "kernel_s")}


def _profile(mode: str | None, device: torch.device):
    """The profiler of a window: CPU and CUDA for ``"trace"``, the card
    alone for ``"card"``; None for none."""
    from torch.profiler import ProfilerActivity, profile

    if mode == "trace":
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        return profile(activities=acts)
    if mode == "card":
        return profile(activities=[ProfilerActivity.CUDA])
    return None


def window_mode(trace: bool, device: torch.device) -> str | None:
    """What rank 0's :func:`portbench.harness.measure_window` records."""
    if trace:
        return "trace"
    return "card" if device.type == "cuda" else None


# ---------------------------------------------------------------------------
# a worker rank
# ---------------------------------------------------------------------------


class _Worker:
    """A worker rank: it answers rank 0's commands, each ``(name, arg)``,
    with ``("ok", value)`` or ``("error", traceback)``, and the last,
    ``finish``, with ``("bye", report)``. The first, ``init``, it answers
    once it has loaded the program and the job, before it joins the cohort,
    so that rank 0 joins only when every worker can."""

    def __init__(self, conn: Connection):
        self.conn = conn
        self.prof = None
        self.job_s: list[float] = []

    def serve(self) -> None:
        _, hello = self.conn.recv()
        try:
            join = self.init(hello)
        except Exception:
            self.conn.send(("error", traceback.format_exc()))
            return
        self.conn.send(("ok", None))
        join()
        while True:
            name, arg = self.conn.recv()
            try:
                value = getattr(self, f"do_{name}")(arg)
            except Exception:
                self.conn.send(("error", traceback.format_exc()))
                continue
            if name == "finish":
                self.conn.send(("bye", value))
                return
            self.conn.send(("ok", value))

    def init(self, hello: dict):
        """Load the program and the job; returns the call that joins the
        cohort."""
        sys.path[:0] = [p for p in hello["sys_path"] if p not in sys.path]
        from ibu_tpu_torch.parallel.multihost import init_distributed

        self.rank, self.ranks = hello["rank"], hello["ranks"]
        if hello["device"] == "cuda":
            self.device = torch.device("cuda", self.rank % torch.cuda.device_count())
        else:
            self.device = torch.device(hello["device"])
        self.job = harness.load_module("jobs", hello["job"])
        self.sync = harness._sync(self.device)
        return lambda: init_distributed(hello["init_url"], self.ranks, self.rank)

    def do_prepare(self, ctx: dict) -> int:
        self.workdir = ctx["workdir"]
        self.state = self.job.prepare({**ctx, "rank": self.rank, "ranks": self.ranks})
        self.state["device"] = self.device
        self.state["span"] = (torch.profiler.record_function if ctx["trace"]
                              else harness._null_span)
        self.keeper = harness.Keeper(ctx["seed"], ctx["params"].get("sampled_jobs"),
                                     self.state["distinct"])
        return self.state["records_per_job"]

    def do_run(self, arg: tuple[int, bool]) -> float:
        i, keep = arg
        t0 = time.perf_counter()
        with self.state["span"]("job"):
            out = self.job.run(self.state, i)
            self.sync()
        call_s = time.perf_counter() - t0
        if keep:
            self.keeper.add(i, out)
            self.job_s.append(call_s)
        return call_s

    def do_start(self, mode: str | None) -> None:
        gc.collect()
        gc.freeze()
        self.mode = mode
        self.prof = _profile(mode, self.device)
        if self.prof is not None:
            self.prof.start()

    def do_stop(self, _) -> dict:
        if self.prof is None:
            return {}
        from portbench import trace as trace_mod

        self.prof.stop()
        path = Path(self.workdir) / f"rank{self.rank}.{self.mode}.json"
        self.prof.export_chrome_trace(str(path))
        self.prof = None
        try:
            if self.mode == "trace":
                return {"trace": trace_mod.summarize(str(path)),
                        "to_merge_s": trace_mod.collective_offsets(str(path))}
            return {"card": trace_mod.card_time(str(path))}
        finally:
            path.unlink(missing_ok=True)

    def do_finish(self, _) -> dict:
        import torch.distributed as dist

        report = {"cards": card_peaks(), "kept": self.keeper.kept(), "job_s": self.job_s,
                  "forbidden": harness.forbidden_modules()}
        if dist.is_initialized():
            dist.destroy_process_group()
        return report


def worker_main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description="A worker rank of a benchmark run; "
                                 "started by the harness, never by hand.")
    ap.add_argument("--fd", type=int, required=True, help="the socket to rank 0")
    args = ap.parse_args(argv)
    conn = Connection(args.fd)
    try:
        _Worker(conn).serve()
    except (EOFError, OSError):
        return 1  # rank 0 went away
    finally:
        conn.close()
    return 0


# ---------------------------------------------------------------------------
# rank 0
# ---------------------------------------------------------------------------


class Cohort:
    """Rank 0's side: a worker process and a socket for each other rank, and
    a thread that reads their answers and kills every worker on a failure
    or a missed deadline."""

    def __init__(self, ranks: int):
        self.ranks = ranks
        self.procs: dict[int, subprocess.Popen] = {}
        self.conns: dict[int, Connection] = {}
        self.answers: queue.Queue = queue.Queue()
        self.due: float | None = None
        self.broken: str | None = None
        self.lock = threading.Lock()
        self.closing = threading.Event()
        self.listener: threading.Thread | None = None

    def start(self, hello: dict) -> None:
        """Start the workers and send each its ``init``; each answers once
        it has loaded the program, then joins the cohort, which is formed
        when rank 0 joins too."""
        script = str(harness.BENCH_DIR / "ranks.py")
        for r in range(1, self.ranks):
            ours, theirs = socket.socketpair()
            with theirs:
                self.procs[r] = subprocess.Popen(
                    [sys.executable, script, "--fd", str(theirs.fileno())],
                    pass_fds=(theirs.fileno(),), stdin=subprocess.DEVNULL, stdout=2)
            self.conns[r] = Connection(ours.detach())
            self.conns[r].send(("init", {**hello, "rank": r}))
        self.due = time.monotonic() + SETUP_DEADLINE_S
        self.listener = threading.Thread(target=self._listen, name="ranks", daemon=True)
        self.listener.start()

    def _listen(self) -> None:
        rank_of = {conn: r for r, conn in self.conns.items()}
        live = list(self.conns.values())
        while live and not self.closing.is_set():
            for conn in wait(live, timeout=0.2):
                r = rank_of[conn]
                try:
                    status, value = conn.recv()
                except (EOFError, OSError):
                    code = self.procs[r].poll()
                    status, value = "died", f"rank {r} ended (exit code {code})"
                if status in ("bye", "died"):
                    live.remove(conn)
                self.answers.put((r, status, value))
                if status in ("error", "died"):
                    self.kill(f"rank {r}: {value}")
            due = self.due
            if due is not None and time.monotonic() > due:
                self.kill("a rank did not answer by its deadline")

    def kill(self, why: str) -> None:
        """Fail the cohort for ``why`` and kill every worker."""
        with self.lock:
            if self.broken is None:
                self.broken = why
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()

    def send(self, name: str, arg=None, deadline_s: float | None = None) -> None:
        """Send ``(name, arg)`` to every worker, answers due within
        ``deadline_s`` (default :data:`DEADLINE_S`)."""
        if self.broken:
            raise RankFailure(self.broken)
        self.due = time.monotonic() + (deadline_s or DEADLINE_S)
        for r, conn in self.conns.items():
            try:
                conn.send((name, arg))
            except OSError as e:
                self.kill(f"rank {r}: {e}")
                raise RankFailure(self.broken) from e

    def collect(self) -> dict[int, object]:
        """Every worker's answer to the command in flight."""
        replies: dict[int, object] = {}
        while len(replies) < len(self.conns):
            try:
                r, status, value = self.answers.get(timeout=0.5)
            except queue.Empty:
                if self.broken:
                    raise RankFailure(self.broken) from None
                continue
            if status in ("error", "died"):
                raise RankFailure(f"rank {r}: {value}")
            replies[r] = value
        self.due = None
        return replies

    def command(self, name: str, arg=None, deadline_s: float | None = None) -> dict[int, object]:
        self.send(name, arg, deadline_s)
        return self.collect()

    def close(self, wait_s: float = 0.0) -> None:
        """Give every worker ``wait_s`` seconds to end, kill any that has
        not, then stop the listener and close the sockets. Safe to call
        twice."""
        t_end = time.monotonic() + wait_s
        for proc in self.procs.values():
            try:
                proc.wait(timeout=max(t_end - time.monotonic(), 0.01))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        self.closing.set()
        if self.listener is not None:
            self.listener.join()
        for conn in self.conns.values():
            conn.close()
        self.conns.clear()


class RankJob:
    """The job as rank 0 runs it: a command to every worker, then its own
    ``run`` on its card and every worker's answer. Set-up's jobs keep
    nothing and have :data:`SETUP_DEADLINE_S`; the window's (``keep``) are
    kept by every rank and timed on rank 0's clock in ``call_s``."""

    def __init__(self, job, cohort: Cohort, sync):
        self.job, self.cohort, self.sync = job, cohort, sync
        self.keep = False
        self.call_s: list[float] = []

    def run(self, state: dict, i: int):
        self.cohort.send("run", (i, self.keep), None if self.keep else SETUP_DEADLINE_S)
        t0 = time.perf_counter()
        try:
            out = self.job.run(state, i)
            self.sync()
        except Exception as e:
            self.cohort.kill(f"rank 0: {type(e).__name__}: {e}")
            raise RankFailure(self.cohort.broken) from e
        call_s = time.perf_counter() - t0
        self.cohort.collect()
        if self.keep:
            self.call_s.append(call_s)
        return out


def run_cell(bench: dict, cell: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float, cfg: dict, params: dict,
             ranks: int) -> tuple[dict, dict]:
    """One run of ``cell`` on ``ranks`` ranks, rank 0 in this process on
    ``device``; as :func:`portbench.harness.run_cell`."""
    import torch.distributed as dist

    from ibu_tpu_torch.parallel.multihost import init_distributed
    from portbench import trace as trace_mod

    job = harness.load_module("jobs", params["job"])
    sync = harness._sync(device)
    workdir = tempfile.mkdtemp(prefix="portbench-")
    cohort = Cohort(ranks)
    init_url = f"file://{workdir}/cohort.store"
    try:
        cohort.start({"sys_path": sys.path, "ranks": ranks, "init_url": init_url,
                      "device": device.type, "job": params["job"]})
        ctx = {"cfg": cfg, "params": params, "seed": seed, "cell": cell, "workdir": workdir}
        state = job.prepare({**ctx, "rank": 0, "ranks": ranks})
        marks = {"prepared_s": time.perf_counter() - t_start}
        cohort.collect()
        marks["workers_loaded_s"] = time.perf_counter() - t_start
        init_distributed(init_url, ranks, 0)
        shares = cohort.command("prepare", {**ctx, "trace": trace}, SETUP_DEADLINE_S)
        marks["joined_s"] = time.perf_counter() - t_start
        state["device"] = device
        state["span"] = torch.profiler.record_function if trace else harness._null_span
        sampled = params.get("sampled_jobs")
        keeper = harness.Keeper(seed, sampled, state["distinct"])
        rank_job = RankJob(job, cohort, sync)
        harness.warm_up(rank_job, state, sampled, sync)
        gc.collect()
        gc.freeze()
        setup_s = time.perf_counter() - t_start

        rank_job.keep = True
        cohort.command("start", window_mode(trace, device))
        window, summary, card = harness.measure_window(rank_job, state, seconds, trace, keeper,
                                                       sync, workdir, params["job"])
        to_merge0 = (trace_mod.collective_offsets(str(Path(workdir) / "trace.json"))
                     if trace else None)
        readings, reports = {}, {}
        if cohort.broken is None:
            try:
                readings = cohort.command("stop")
                reports = cohort.command("finish")
            except RankFailure:
                traceback.print_exc()
        cards0 = card_peaks()
        kept0 = keeper.kept()
        del keeper
        cohort.close(EXIT_S)
        if dist.is_initialized():
            dist.destroy_process_group()
        gc.unfreeze()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        outputs = {r: dict(rep["kept"]) for r, rep in reports.items()}
        kept = [(i, [out] + [outputs.get(r, {}).get(i) for r in range(1, ranks)])
                for i, out in kept0]
        checks, reference_s = harness.compare_kept(job, state, kept)
    finally:
        cohort.close()
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(workdir, ignore_errors=True)

    found = [f"{name} (rank {r})" for r, rep in sorted(reports.items()) for name in rep["forbidden"]]
    if found:
        raise harness.ForbiddenModules(found)

    share = [state["records_per_job"]] + [shares[r] for r in range(1, ranks)]
    rank_runs = [{"rank": 0, "job_s": rank_job.call_s, "trace": summary, "card": card,
                  "to_merge_s": to_merge0, "records_per_job": share[0], "cards": cards0}]
    for r in range(1, ranks):
        rank_runs.append({"rank": r, "job_s": reports.get(r, {}).get("job_s", []),
                          "trace": readings.get(r, {}).get("trace"),
                          "card": readings.get(r, {}).get("card"),
                          "to_merge_s": readings.get(r, {}).get("to_merge_s"),
                          "records_per_job": share[r],
                          "cards": reports.get(r, {}).get("cards", [])})
    if not trace:
        # the card's reading is every rank's, so are the records
        card = summed_card([rr["card"] for rr in rank_runs]) if card is not None else None
        window = {**window, "records": len(window["job_s"]) * sum(share)}
    n_cards, fullest = count_cards([rr["cards"] for rr in rank_runs])
    device_info = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": n_cards if device.type == "cuda" else 1,
        "memory_peak_bytes": int(fullest),
    }
    if summary is not None:
        busy = [rr["trace"]["busy_s"] for rr in rank_runs if rr["trace"] is not None]
        device_info.update(busy_s=statistics.mean(busy), window_s=summary["window_s"])
    run = {"window": window, "setup_s": setup_s, "trace": summary, "card": card,
           "ranks": rank_runs}
    result, checks = harness.report(bench, cell, seed, trace, run, kept, checks, device_info,
                                    reference_s)
    print(f"portbench {cell} set-up: "
          + " ".join(f"{k}={v:.3f}" for k, v in marks.items()), file=sys.stderr)
    for rr in rank_runs:
        _print_rank(cell, rr)
    return result, checks


def _print_rank(cell: str, rr: dict) -> None:
    """One rank's line on standard error: its cards, records, call times and
    card readings."""
    times = np.array(rr["job_s"]) * 1e3
    cards = ",".join(c for c, _ in rr["cards"]) or "-"
    line = (f"portbench {cell} rank={rr['rank']} cards={cards} "
            f"records_per_job={rr['records_per_job']} jobs={len(times)}")
    if len(times):
        q = np.percentile(times, [50, 95])
        line += f" call_ms p50={q[0]:.3f} p95={q[1]:.3f} max={times.max():.3f}"
    if rr["card"] is not None:
        line += f" card_busy_s={rr['card']['busy_s']:.6f} card_kernel_s={rr['card']['kernel_s']:.6f}"
    merge = [t for t in rr["to_merge_s"] or () if t is not None]
    if merge:
        line += f" to_merge_ms p50={statistics.median(merge) * 1e3:.3f}"
    if rr["trace"] is not None:
        line += (f" busy_s={rr['trace']['busy_s']:.6f} kernel_s={rr['trace']['kernel_s']:.6f}"
                 f" window_s={rr['trace']['window_s']:.6f}")
    print(line, file=sys.stderr)


if __name__ == "__main__":
    sys.exit(worker_main(sys.argv[1:]))
