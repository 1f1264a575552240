"""Cohorts of CPU processes for the port's cohort tests.

:func:`launch` starts ``world`` processes, each a rank of one Gloo cohort
that meets at a ``file://`` store in the test's directory, and runs the same
list of tasks in every rank, in order. A task is ``(name, task, kwargs)``,
``task`` naming a function of this module that takes the rank, the world
size and ``kwargs``. Each rank writes ``{name: ("ok", value)}`` or ``{name:
("err", exception type, text)}`` to a file; :func:`launch` returns them by
rank. Every rank runs under one deadline: a rank still running at it is
killed with the rest and the launch fails, so a hang fails its test instead
of stalling the suite. :func:`launch_exits` also returns each rank's exit
code, a rank whose task raised exiting 3, for tests that need every rank of a
failing cohort to exit nonzero.

Run as a script, the module is one rank: ``python tests/torch_cohort.py
TASKS STORE WORLD RANK``.
"""

from __future__ import annotations

import contextlib
import io
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
#: seconds a whole launch may take before its ranks are killed
TIMEOUT = 240


def _run(world: int, tasks: list, workdir, init: bool, timeout: float,
         exit_on_error: bool) -> list[int]:
    """Start the ranks, wait for every one under one deadline (killing them
    all at it) and return their exit codes."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    spec = workdir / "tasks.pkl"
    spec.write_bytes(pickle.dumps({"tasks": tasks, "init": init,
                                   "exit_on_error": exit_on_error}))
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    env.pop("IBU_POD_SORT_ENGINE", None)
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, str(spec), str(workdir / "store"), str(world), str(r)],
            cwd=workdir, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for r in range(world)
    ]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            logs.append(err.decode(errors="replace")[-4000:])
    except subprocess.TimeoutExpired:
        raise AssertionError(f"the {world}-rank cohort did not end within {timeout} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if not exit_on_error:
        for r, p in enumerate(procs):
            assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{logs[r]}"
    return [p.returncode for p in procs]


def _results(workdir, world: int) -> list:
    return [pickle.loads((Path(workdir) / f"rank{r}.pkl").read_bytes()) for r in range(world)]


def launch(world: int, tasks: list, workdir, init: bool = True, timeout: float = TIMEOUT):
    """Run ``tasks`` in every rank of a ``world``-rank cohort (joined with
    ``init_distributed`` first unless ``init`` is false: the CLI joins by
    its own flags); returns each rank's results, by rank."""
    _run(world, tasks, workdir, init, timeout, exit_on_error=False)
    return _results(workdir, world)


def launch_exits(world: int, tasks: list, workdir, timeout: float = TIMEOUT):
    """:func:`launch`, but a rank whose task raised exits 3: returns each
    rank's exit code and its results, by rank."""
    rcs = _run(world, tasks, workdir, True, timeout, exit_on_error=True)
    return rcs, _results(workdir, world)


@contextlib.contextmanager
def patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def env_var(name: str, value):
    old = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


# ---------------------------------------------------------------------------
# tasks (each runs in every rank)
# ---------------------------------------------------------------------------


def sharded_sort(rank, world, path, device="cpu", **kwargs):
    """``sharded_sort_records`` of the records in ``path`` (.npy) on
    ``device``; returns the sorted array (rank 0) and this rank's count
    matrix."""
    import numpy as np

    from ibu_tpu_torch.parallel import sort as MS

    seen = {}
    inner = MS._sample_sort

    def spy(*args, **kw):
        run, matrix = inner(*args, **kw)
        seen["matrix"] = matrix
        return run, matrix

    with patched(MS, "_sample_sort", spy):
        out = MS.sharded_sort_records(np.load(path), device=device, **kwargs)
    return {"out": out if rank == 0 else None, "matrix": seen["matrix"]}


def sort_file_mesh(rank, world, src, dst, **kwargs):
    from ibu_tpu_torch.parallel import sort as MS

    MS.sort_file_mesh(src, dst, device="cpu", **kwargs)


def sort_file(rank, world, src, dst, env=None, **kwargs):
    """``multihost_sort_file``; returns what it printed on stderr."""
    from ibu_tpu_torch.parallel import multihost as MH

    err = io.StringIO()
    with env_var("IBU_POD_SORT_ENGINE", env), contextlib.redirect_stderr(err):
        MH.multihost_sort_file(src, dst, device="cpu", **kwargs)
    return err.getvalue()


def sort_file_rank1_without_native(rank, world, src, dst):
    """``engine="auto"`` with the native runtime missing on rank 1 only."""
    from ibu_tpu_torch import native

    available = native.available if rank != 1 else (lambda: False)
    with patched(native, "available", available):
        return sort_file(rank, world, src, dst)


def sort_file_bad_override_on_rank1(rank, world, src, dst):
    return sort_file(rank, world, src, dst, env="bogus" if rank == 1 else None)


def sort_file_failing_on_rank1(rank, world, src, dst, stage):
    """``multihost_sort_file`` with one native step of rank 1 raising."""
    from ibu_tpu_torch import native

    def boom(*args, **kwargs):
        raise OSError(f"injected failure on rank {rank}")

    fn = boom if rank == 1 else getattr(native, stage)
    with patched(native, stage, fn):
        return sort_file(rank, world, src, dst, engine="host")


def file_stats(rank, world, path, **kwargs):
    from ibu_tpu_torch.parallel import multihost as MH

    return MH.multihost_file_stats(path, device="cpu", **kwargs)


def histogram(rank, world, path, **kwargs):
    from ibu_tpu_torch.parallel import multihost as MH

    return MH.multihost_barcode_histogram(path, device="cpu", **kwargs)


def map_reduce_stacked(rank, world, path, **kwargs):
    """A ``MapReduce`` whose merge returns the states stacked by rank."""
    from ibu_tpu_torch.parallel import device as D
    from ibu_tpu_torch.parallel import multihost as MH

    engine = D.MapReduce(init=D._stats_init, update=D._stats_update, merge=lambda st: st)
    return MH.multihost_map_reduce(path, engine, device="cpu", **kwargs)


def map_reduce_collectives(rank, world, path):
    """The number of ``all_gather`` calls the stats engine's merge makes."""
    import torch.distributed as dist

    from ibu_tpu_torch.parallel import device as D
    from ibu_tpu_torch.parallel import multihost as MH

    MH._groups()  # built on first use: not the merge's own traffic
    calls = []
    inner = dist.all_gather

    def spy(*args, **kwargs):
        calls.append(1)
        return inner(*args, **kwargs)

    with patched(dist, "all_gather", spy):
        merged = MH.multihost_map_reduce(path, D.STATS_MAP_REDUCE, device="cpu")
    return {"collectives": len(calls), "count": int(merged["count"])}


def map_reduce_failing_on_rank1(rank, world, path):
    from ibu_tpu_torch.parallel import device as D
    from ibu_tpu_torch.parallel import multihost as MH

    def update(state, records):
        if rank == 1:
            raise RuntimeError("injected update failure")
        return D._stats_update(state, records)

    engine = D.MapReduce(init=D._stats_init, update=update)
    return MH.multihost_map_reduce(path, engine, device="cpu")


def resume_stats(rank, world, states):
    """Rank ``s`` resumes the JAX per-shard stats state ``s`` over no batch."""
    from ibu_tpu_torch.ops.u64 import stats_state_from_jax
    from ibu_tpu_torch.parallel import device as D

    state = stats_state_from_jax(states, shard=rank)
    return D.finalize_stats(D.STATS_MAP_REDUCE.run_placed(iter(()), "cpu", state=state))


def resume_histogram(rank, world, state, path, capacity):
    """Rank ``s`` resumes the JAX histogram table as shard ``s`` and folds
    its range of ``path``."""
    from ibu_tpu_torch import MmapReader
    from ibu_tpu_torch.ops.u64 import histogram_state_from_jax
    from ibu_tpu_torch.parallel import device as D
    from ibu_tpu_torch.parallel import multihost as MH

    hist = D.DeviceHistogram(capacity=capacity, device="cpu")
    hist.resume(histogram_state_from_jax(state, shard=rank))
    return hist.run(MH.local_record_batches(MmapReader(path), 700))


def backend(rank, world, device="cpu"):
    from ibu_tpu_torch.parallel import multihost as MH

    return {"exchange": MH.exchange_backend(device), "rank": MH.process_index(),
            "world": MH.process_count()}


def call(rank, world, fn, env=None, codec=None, **kwargs):
    """``multihost.<fn>(**kwargs)`` under ``IBU_POD_SORT_ENGINE=env`` and
    ``IBU_AUTO_ENGINE=codec`` (each unset when None); returns its result."""
    from ibu_tpu_torch.parallel import multihost as MH

    with env_var("IBU_POD_SORT_ENGINE", env), env_var("IBU_AUTO_ENGINE", codec):
        return getattr(MH, fn)(**kwargs)


def _writes_failing_on_rank1(rank):
    """``multihost._pwrite_all`` raising on rank 1, as it is elsewhere."""
    from ibu_tpu_torch.parallel import multihost as MH

    def boom(fd, data, offset):
        raise OSError(f"injected failure on rank {rank}")

    return patched(MH, "_pwrite_all", boom if rank == 1 else MH._pwrite_all)


def call_failing_write_on_rank1(rank, world, fn, **kwargs):
    """:func:`call` with rank 1's first ``_pwrite_all`` raising."""
    with _writes_failing_on_rank1(rank):
        return call(rank, world, fn, **kwargs)


def call_failing_export_on_rank1(rank, world, **kwargs):
    """``multihost_export_fastq`` with rank 1's ``export_fastq`` raising
    after it has created its shard."""
    from ibu_tpu_torch import pipelines as PL

    inner = PL.export_fastq

    def boom(ibu_path, fastq_path, **kw):
        open(fastq_path, "wb").close()
        raise OSError(f"injected failure on rank {rank}")

    with patched(PL, "export_fastq", boom if rank == 1 else inner):
        return call(rank, world, "multihost_export_fastq", **kwargs)


def call_without_card(rank, world, fn, **kwargs):
    """:func:`call` with ``torch.cuda.is_available`` answering False."""
    import torch

    with patched(torch.cuda, "is_available", lambda: False):
        return call(rank, world, fn, **kwargs)


def cli(rank, world, argv, env=None):
    """``python -m ibu_tpu_torch`` in process as this rank, ``--distributed``
    and the cohort's three flags appended: ``(exit code, stdout, stderr)``,
    the output of the program itself (Gloo's own lines go to the file
    descriptors, not here)."""
    from ibu_tpu_torch.__main__ import main

    argv = list(argv) + ["--distributed", "--coordinator", f"file://{STORE}",
                         "--num-processes", str(world), "--process-id", str(rank)]
    out, err = io.StringIO(), io.StringIO()
    with env_var("IBU_POD_SORT_ENGINE", env), contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def cli_failing_write_on_rank1(rank, world, argv):
    """:func:`cli` with rank 1's first ``_pwrite_all`` raising."""
    with _writes_failing_on_rank1(rank):
        return cli(rank, world, argv)


def cli_failing_on_rank1(rank, world, argv):
    from ibu_tpu_torch import native

    def boom(*args, **kwargs):
        raise OSError(f"injected failure on rank {rank}")

    fn = boom if rank == 1 else native.sort_chunks_range
    with patched(native, "sort_chunks_range", fn):
        return cli(rank, world, argv, env="host")


def fuzz_tool(rank, world, tool, in_path, out, allow_path, fail_rank):
    """One cohort tool of the failure-injection fuzz on ``device="cpu"``,
    with rank ``fail_rank``'s first write raising (the host sort's merge,
    which writes through the native library, for ``sort-host``)."""
    import numpy as np

    from ibu_tpu_torch import native
    from ibu_tpu_torch.parallel import multihost as MH

    def boom(*args, **kwargs):
        raise OSError(28, "injected ENOSPC (fuzz)")

    owner, name = (native, "merge_runs_interval") if tool == "sort-host" else (MH, "_pwrite_all")
    allow = np.loadtxt(allow_path, dtype=np.uint64, ndmin=1)
    calls = {
        "dedup": lambda: MH.multihost_dedup_file(in_path, out, device="cpu"),
        "filter": lambda: MH.multihost_filter_file(in_path, out, allow),
        "correct": lambda: MH.multihost_correct_file(in_path, out, allow, device="cpu"),
        "count": lambda: MH.multihost_count_matrix(in_path, out),
        "sort-host": lambda: MH.multihost_sort_file(in_path, out, device="cpu", engine="host"),
        "sort-mesh": lambda: MH.multihost_sort_file(in_path, out, device="cpu", engine="mesh"),
    }
    with patched(owner, name, boom if rank == fail_rank else getattr(owner, name)):
        return calls[tool]()


#: the rendezvous file of this rank's cohort
STORE = ""


def _main(spec: str, store: str, world: int, rank: int) -> None:
    global STORE
    import torch

    STORE = store
    torch.set_num_threads(1)
    job = pickle.loads(Path(spec).read_bytes())
    if job["init"]:
        from ibu_tpu_torch.parallel.multihost import init_distributed

        init_distributed(f"file://{store}", world, rank)
    results = {}
    for name, task, kwargs in job["tasks"]:
        try:
            results[name] = ("ok", globals()[task](rank, world, **kwargs))
        except Exception as e:  # noqa: BLE001 (recorded for the test to judge)
            results[name] = ("err", type(e).__name__, str(e))
    Path(spec).with_name(f"rank{rank}.pkl").write_bytes(pickle.dumps(results))
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    if job["exit_on_error"] and any(r[0] == "err" for r in results.values()):
        sys.exit(3)


if __name__ == "__main__":
    _main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
