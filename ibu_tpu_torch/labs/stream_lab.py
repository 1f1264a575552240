"""File → device streaming: the link, the engine, where its time goes, and
the host engine beside it.

    python -m ibu_tpu_torch.labs.stream_lab [--records 100] [--reps 3]
        [--batch-records 4194304] [--phases t,e,b,h] [--workdir DIR] [--device cpu]

The counterpart of ``tools/stream_lab.py``, phase for phase, over ``--reps``
patterned files of ``--records`` million records (each with a different
salt, so each rep streams different bytes; :func:`make_file` writes the
reference's bytes and closed-form oracle):

- ``t`` (transport): :func:`ibu_tpu_torch.ops.u64.to_device` of ``(B, 3)``
  int64 wire batches of distinct random bytes at 2^20, 2^22 and
  ``--batch-records`` records, after one untimed put of each size; every
  placed batch equals its host bytes;
- ``e`` (engine): :func:`ibu_tpu_torch.parallel.device.stream_file_stats`
  over each file, each result equal to its oracle;
- ``b`` (breakdown): one pass over the first file with each stage forced
  synchronous: the zero-copy slice and wire view
  (``record_batches_from_mmap``), the put, and the stats update; the folded
  state equals the oracle;
- ``h`` (host): :func:`ibu_tpu_torch.native.checksum_parallel` on the first
  file, equal to the oracle.

Files go in ``/dev/shm`` (where it has room for them, else a temporary
directory; ``--workdir`` chooses) and are removed at exit. Every phase runs
and is checked before any line is printed; then one JSON line per phase.
Timing: host clock around each call ending in ``torch.cuda.synchronize``, as
in the reference: these phases include host work.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time

import numpy as np

from ibu_tpu_torch import native
from ibu_tpu_torch.io.mmap import MmapReader
from ibu_tpu_torch.labs import _capacity as C
from ibu_tpu_torch.ops.u64 import U64_MASK, to_device, wire_view
from ibu_tpu_torch.parallel.device import (
    STATS_MAP_REDUCE,
    finalize_stats,
    record_batches_from_mmap,
    stream_file_stats,
)
from ibu_tpu_torch.utils.datagen import write_patterned_file

RECORD_SIZE = 24
HEADER_BYTES = 32
SALT_STEP = 7919
PHASES = {"t": "transport", "e": "engine", "b": "breakdown", "h": "host"}


def make_file(path: str, n: int, salt: int) -> dict:
    """Patterned file with closed-form sums; ``salt`` varies the bytes
    (``tools/stream_lab.py::make_file``)."""
    salt_u = np.uint64(salt)

    def fields(i: np.ndarray):
        return (i + salt_u) % np.uint64(1_000_000), i * np.uint64(2), i

    write_patterned_file(path, n, fields)
    # (i+salt) % 1M over any full 1M-cycle sums to 0+..+999999
    full, tail = divmod(n, 1_000_000)
    bc = full * (999_999 * 1_000_000 // 2)
    bc += int(((np.arange(tail, dtype=np.uint64) + salt_u) % np.uint64(1_000_000)).sum())
    return {
        "count": n,
        "barcode_sum": bc & U64_MASK,
        "umi_sum": (2 * (n * (n - 1) // 2)) & U64_MASK,
        "index_sum": (n * (n - 1) // 2) & U64_MASK,
    }


def phase_transport(device, n_batch: int, reps: int) -> dict:
    """``to_device`` of distinct random ``(B, 3)`` int64 batches."""
    rng = np.random.default_rng(0)
    out = {}
    for b in dict.fromkeys((1 << 20, 1 << 22, n_batch)):
        raws = [np.frombuffer(rng.bytes(b * RECORD_SIZE), np.int64).reshape(b, 3)
                for _ in range(reps + 1)]
        C.clocked(lambda: to_device(raws[0], device), device)  # the size's pinned buffer
        times = []
        for raw in raws[1:]:
            dev, dt = C.clocked(lambda raw=raw: to_device(raw, device), device)
            C.require(C.holds(dev, raw), f"a {b}-record put")
            times.append(dt)
        best = min(times)
        out[f"put_{b >> 20}Mrec"] = {"bytes": b * RECORD_SIZE, "best_s": best,
                                     "GB_s": b * RECORD_SIZE / best / 1e9, "all_s": times}
        C.log_time(device, f"  to_device {b} records: "
                   f"{b * RECORD_SIZE / best / 1e9:.2f} GB/s best of {reps}")
    return out


def phase_engine(device, paths: list[str], oracles: list[dict], n_batch: int) -> dict:
    stream_file_stats(MmapReader(paths[0]), device=device, batch_records=n_batch)  # warm
    times = []
    for path, want in zip(paths, oracles):
        stats, dt = C.clocked(lambda path=path: stream_file_stats(
            MmapReader(path), device=device, batch_records=n_batch), device)
        C.require(stats == want, f"stream_file_stats of {path}: {stats} != {want}")
        times.append(dt)
    nbytes = os.path.getsize(paths[0]) - HEADER_BYTES
    n = nbytes // RECORD_SIZE
    best = min(times)
    C.log_time(device, f"  stream_file_stats: {nbytes / best / 1e9:.2f} GB/s best of {len(times)}")
    return {"batch_records": n_batch, "records": n, "bytes": nbytes, "best_s": best,
            "GB_s": nbytes / best / 1e9, "Mrec_s": n / best / 1e6, "all_s": times}


def phase_breakdown(device, path: str, want: dict, n_batch: int) -> dict:
    """Each stage of the engine forced synchronous, over one pass."""
    reader = MmapReader(path)
    state = STATS_MAP_REDUCE.init(device)
    t_slice = t_put = t_step = 0.0
    nb = 0
    t_all = time.perf_counter()
    for batch in record_batches_from_mmap(reader, n_batch):
        nb += 1
        raw, dt = C.clocked(lambda batch=batch: wire_view(batch), device)
        t_slice += dt
        dev, dt = C.clocked(lambda raw=raw: to_device(raw, device), device)
        t_put += dt
        state, dt = C.clocked(lambda dev=dev, state=state: STATS_MAP_REDUCE.update(state, dev),
                              device)
        t_step += dt
    stats = finalize_stats(STATS_MAP_REDUCE.finalize(state))
    total = time.perf_counter() - t_all
    C.require(stats == want, f"the synchronous fold of {path}: {stats} != {want}")
    nbytes = os.path.getsize(path) - HEADER_BYTES
    C.log_time(device, f"  breakdown over {nb} batches: slice {t_slice:.3f} s, put {t_put:.3f} s, "
          f"step {t_step:.3f} s")
    return {"batches": nb, "slice_s": t_slice, "device_put_s": t_put, "step_s": t_step,
            "total_s": total, "put_GB_s": nbytes / t_put / 1e9 if t_put else None}


def phase_host(device, path: str, want: dict, reps: int) -> dict:
    if not native.available():
        return {"skipped": native.load_error()}
    nbytes = os.path.getsize(path) - HEADER_BYTES
    n = nbytes // RECORD_SIZE
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        sums = native.checksum_parallel(path, n)
        times.append(time.perf_counter() - t0)
        C.require(sums == (want["barcode_sum"], want["umi_sum"], want["index_sum"]),
                  f"checksum_parallel of {path}")
    best = min(times)
    C.log_time(device, f"  native host engine: {nbytes / best / 1e9:.2f} GB/s")
    return {"best_s": best, "GB_s": nbytes / best / 1e9, "Mrec_s": n / best / 1e6, "all_s": times}


def run(device, n: int, reps: int, n_batch: int, phases: list[str], workdir: str | None
        ) -> list[dict]:
    native.available()  # the first call of a process builds the host library: untimed
    wd = C.scratch_dir("ibu_stream_", reps * n * RECORD_SIZE, workdir)
    C.log(f"stream_lab: {C.device_name(device)}, {reps} files of {n} records "
          f"({n * RECORD_SIZE / 1e9:.2f} GB each) in {wd}")
    results = {}
    try:
        paths, oracles = [], []
        for r in range(reps):
            path = os.path.join(wd, f"stream_{r}.ibu")
            oracles.append(make_file(path, n, salt=r * SALT_STEP))
            paths.append(path)
        if "t" in phases:
            C.log("phase t: transport")
            results["t"] = phase_transport(device, n_batch, reps)
        if "e" in phases:
            C.log("phase e: engine end to end")
            results["e"] = phase_engine(device, paths, oracles, n_batch)
        if "b" in phases:
            C.log("phase b: synchronous breakdown")
            results["b"] = phase_breakdown(device, paths[0], oracles[0], n_batch)
        if "h" in phases:
            C.log("phase h: native host engine")
            results["h"] = phase_host(device, paths[0], oracles[0], reps)
    finally:
        shutil.rmtree(wd, ignore_errors=True)
    timings = C.on_card(device)
    return [{"phase": PHASES[p], "records": n, "bytes": n * RECORD_SIZE, "platform": device.type,
             **(results[p] if timings else {})} for p in phases]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ibu_tpu_torch.labs.stream_lab",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--records", type=float, default=100.0, help="millions of records per file")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--batch-records", type=int, default=4 << 20)
    ap.add_argument("--phases", default="t,e,b,h",
                    help="comma list of t(ransport) e(ngine) b(reakdown) h(ost)")
    ap.add_argument("--workdir", default=None, help="where the files go (default /dev/shm)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu: the checks, no timing")
    args = ap.parse_args(argv)
    phases = list(dict.fromkeys(args.phases.split(",")))
    if not set(phases) <= set(PHASES):
        ap.error(f"--phases takes t, e, b and h, got {args.phases!r}")
    device = C.lab_device(args.device, ap.prog)
    if device is None:
        return 2
    n = int(args.records * 1_000_000)
    for line in run(device, n, args.reps, args.batch_records, phases, args.workdir):
        C.emit(line, device, "host clock" if line["phase"] == "host" else C.HOST_CLOCK)
    return 0


if __name__ == "__main__":
    sys.exit(main())
