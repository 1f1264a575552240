"""Entry points of the port: the one-card forward step and a dry run
of the cohort.

Counterpart of the repository's ``__graft_entry__.py``. The "flagship model"
is the fused record pipeline: ASCII barcode/UMI rows and an index become
2-bit-packed ``(N, 3)`` int64 records (the ``encode_records`` CUDA kernel)
and their exact mod-2^64 field sums. :func:`entry` returns that step and its
8192-record example batch on the card; :func:`dryrun_multichip` starts a
cohort of ``n`` ranks (one process each, one Gloo group, a ``file://``
rendezvous) and runs :func:`dryrun_rank` in every rank: encode a block, fold
it with ``STATS_MAP_REDUCE``, ``all_reduce`` the count (the reference's
``psum``), merge the states, and sort the reference's records with the mesh
sample sort, each checked against numpy.

    python -m ibu_tpu_torch.entry [--device cpu] [--ranks N]

prints ``entry OK: ...`` and ``dryrun_multichip(N) OK`` (N defaults to 2:
two ranks on one card exchange over Gloo). It runs on the card; with no card
it exits 2 unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ibu_tpu_torch.constructs.record import make_records
from ibu_tpu_torch.ops import codec_cuda
from ibu_tpu_torch.ops.stats import field_sums
from ibu_tpu_torch.ops.u64 import U64_MASK
from ibu_tpu_torch.parallel import multihost as MH
from ibu_tpu_torch.parallel.device import STATS_MAP_REDUCE, finalize_stats
from ibu_tpu_torch.parallel.sort import sharded_sort_records
from ibu_tpu_torch.utils.device import resolve_device, select_device

#: records of :func:`entry`'s example batch
EXAMPLE_RECORDS = 8192
#: seconds a dry run's cohort may take before its ranks are killed
DRYRUN_TIMEOUT = 240.0


def _example_batch(n: int, bc_len: int = 16, umi_len: int = 12):
    """The reference's example batch (the same draws from ``default_rng(0)``)
    in the port's layout: ASCII rows ``(n, bc_len)`` and ``(n, umi_len)``
    uint8 (the transpose of the reference's planes) and the ``(n,)`` int64
    index (the reference's low u32 word; the high word is 0)."""
    rng = np.random.default_rng(0)
    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    bc_rows = np.ascontiguousarray(alphabet[rng.integers(0, 4, (bc_len, n))].T)
    umi_rows = np.ascontiguousarray(alphabet[rng.integers(0, 4, (umi_len, n))].T)
    index = rng.integers(0, 1 << 32, n).astype(np.uint32).astype(np.int64)
    return torch.from_numpy(bc_rows), torch.from_numpy(umi_rows), torch.from_numpy(index)


def _forward(bc_rows: torch.Tensor, umi_rows: torch.Tensor, index: torch.Tensor):
    """The flagship step: ``(records, sums)``, the ``(N, 3)`` int64 records
    and their ``(3,)`` int64 field sums mod 2^64."""
    records = codec_cuda.encode_records(bc_rows, umi_rows, index)
    return records, field_sums(records)


def entry(device: str | torch.device | None = None):
    """Return ``(fn, example_args)``: the flagship forward step and its
    8192-record example batch on ``device``.

    ``fn(bc_rows, umi_rows, index)`` encodes the rows with the
    ``encode_records`` kernel and returns ``(records, sums)``. ``device=None``
    is the current card (a :class:`~ibu_tpu_torch.errors.NoCardError` without
    one); ``device="cpu"`` takes the plain torch versions."""
    device = resolve_device(device)
    args = tuple(t.to(device) for t in _example_batch(EXAMPLE_RECORDS))
    return _forward, args


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"dry run: {what}")


def _all_reduce_count(count: torch.Tensor, device: torch.device) -> int:
    """The global record count on every rank: ``all_reduce`` over the
    cohort's NCCL group where every rank has its own card, else over Gloo
    from the host (NCCL refuses two ranks on one card)."""
    if not dist.is_initialized():
        return int(count)
    nccl = MH.exchange_backend(device) == "nccl"
    total = count.to(count.device if nccl else "cpu", copy=True)  # the state stays as it is
    dist.all_reduce(total, group=MH._groups()["nccl" if nccl else "gloo"])
    return int(total)


def dryrun_rank(
    rank: int,
    world: int,
    device: str | torch.device | None = None,
    records_per_rank: int = 64,
) -> dict:
    """One rank's dry run of the cohort pipeline (in a cohort of ``world``
    ranks, joined already; a world of one needs no group).

    The rank encodes its block of the reference's ``world·records_per_rank``
    example records, folds it with ``STATS_MAP_REDUCE``, ``all_reduce``\\ s
    the count, merges every rank's state (``MapReduce.finalize``), and sorts
    the reference's ``default_rng(1)`` records with ``sharded_sort_records``.
    Each result is checked against numpy; a failure on any rank raises on
    every rank. Returns what was checked."""
    _require(MH.process_count() == world and MH.process_index() == rank,
             f"rank {rank} of {world} runs in rank {MH.process_index()} of "
             f"{MH.process_count()}")
    n = world * records_per_rank
    lo, hi = rank * records_per_rank, (rank + 1) * records_per_rank
    failed = None
    try:
        device = resolve_device(device)
        bc_rows, umi_rows, index = _example_batch(n)
        records = codec_cuda.encode_records(
            bc_rows[lo:hi].to(device), umi_rows[lo:hi].to(device), index[lo:hi].to(device))
        state = STATS_MAP_REDUCE.update(STATS_MAP_REDUCE.init(device), records)
    except BaseException as e:
        failed = e
    MH._cohort_checkpoint(failed, "the dry run's encode and fold")
    total = _all_reduce_count(state["count"], device)
    _require(total == n, f"the all-reduced count is {total}, not {n}")
    merged = finalize_stats(STATS_MAP_REDUCE.finalize(state))
    want_index = int(index.numpy().sum(dtype=np.uint64)) & U64_MASK
    _require(merged["count"] == n, f"the merged count is {merged['count']}, not {n}")
    _require(merged["index_sum"] == want_index,
             f"the merged index sum is {merged['index_sum']}, not numpy's {want_index}")

    rng = np.random.default_rng(1)
    recs = make_records(
        rng.integers(0, 1 << 32, n).astype(np.uint64),
        rng.integers(0, 1 << 24, n).astype(np.uint64),
        np.arange(n, dtype=np.uint64),
    )
    got = sharded_sort_records(recs, device=device, bc_len=16, umi_len=12, index_bits=32)
    # np.sort(recs, order=("barcode", "umi", "index")): with barcodes below
    # 2^32, UMIs below 2^24 and the index the input order, a stable argsort
    # of barcode·2^24 + umi gives that order, and at 2^23 records takes a
    # tenth of the structured sort's 11 s
    want = recs[np.argsort((recs["barcode"] << np.uint64(24)) | recs["umi"], kind="stable")]
    _require(np.array_equal(got, want), "the mesh sort diverged from numpy's")
    return {**merged, "all_reduced_count": total, "sorted": len(got)}


def dryrun_multichip(
    n: int,
    device: str | torch.device | None = None,
    records_per_rank: int = 64,
    timeout: float = DRYRUN_TIMEOUT,
) -> None:
    """Start ``n`` ranks of one Gloo cohort (one process each, rank ``r`` on
    card ``r % count``) and run :func:`dryrun_rank` in every rank. Raises
    ``RuntimeError`` if a rank exits nonzero, or if the cohort has not ended
    within ``timeout`` seconds (its ranks are then killed)."""
    device = resolve_device(device)
    root = str(Path(__file__).resolve().parents[1])
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p)}
    with tempfile.TemporaryDirectory(prefix="ibu_dryrun_") as tmp:
        argv = ["--store", f"file://{Path(tmp) / 'store'}", "--world", str(n),
                "--records-per-rank", str(records_per_rank),
                *(["--device", str(device)] if device.type == "cpu" else [])]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "ibu_tpu_torch.entry", "--rank", str(r), *argv],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(n)]
        deadline = time.monotonic() + timeout
        logs = []
        try:
            for p in procs:
                out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
                logs.append(out.decode(errors="replace"))
        except subprocess.TimeoutExpired:
            raise RuntimeError(
                f"dryrun_multichip({n}): the cohort did not end within {timeout} s") from None
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(f"dryrun_multichip({n}): rank {bad[0]} exited "
                           f"{procs[bad[0]].returncode}:\n{logs[bad[0]][-4000:]}")


def _rank_main(args) -> int:
    """One rank of :func:`dryrun_multichip`'s cohort."""
    MH.init_distributed(args.store, args.world, args.rank)
    try:
        got = dryrun_rank(args.rank, args.world, args.device, args.records_per_rank)
        print(f"rank {args.rank}: {got}", flush=True)
        return 0
    except Exception as e:  # noqa: BLE001 (reported, and the rank exits 1)
        print(f"rank {args.rank}: {type(e).__name__}: {e}", flush=True)
        return 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ibu_tpu_torch.entry",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu: the plain torch versions; without a card "
                         "and without --device cpu the command exits 2")
    ap.add_argument("--ranks", type=int, default=2, help="ranks of the dry run's cohort")
    # one rank of the dry run's cohort (dryrun_multichip starts these)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--records-per-rank", type=int, default=64, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return _rank_main(args)
    device = select_device(args.device, ap.prog)
    if device is None:
        return 2
    fn, example = entry(device)
    out = fn(*example)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print("entry OK:", tuple((tuple(x.shape), str(x.dtype)) for x in out), flush=True)
    dryrun_multichip(args.ranks, device)
    print(f"dryrun_multichip({args.ranks}) OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
