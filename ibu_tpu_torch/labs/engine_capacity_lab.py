"""Device-side capacity of the statistics engine: the streaming stats fold
minus transport.

    python -m ibu_tpu_torch.labs.engine_capacity_lab [--batch-records 1048576]
        [--buffers 8] [--k 16 64] [--reps 3] [--device cpu]

The counterpart of ``tools/engine_capacity_lab.py``. ``--buffers`` distinct
batches of ``default_rng(13)`` ``(B, 6)`` uint32 words, viewed as the wire
``(B, 3)`` int64 records, are placed on the card beforehand; then the
production update (:data:`ibu_tpu_torch.parallel.device.STATS_MAP_REDUCE`'s
``update``, a count and three wrapping int64 field sums) is folded over them
``k`` times, cycling the buffers, with the state chained. The fold runs
directly over the resident batches, not through ``run_placed``, whose
``finalize`` fetches the state. This is the rate the stream engine would
reach if the host→device link did not feed it.

The oracle, checked before anything is timed: one fold over every buffer,
through ``finalize_stats``, equals the numpy sums mod 2^64 (random hi words
set bit 63, so the int64 sums wrap and are compared as unsigned). Timing:
CUDA events around each chain (:mod:`._capacity`). The bound is 24 bytes
read per record. One JSON line on stdout.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ibu_tpu_torch.labs import _capacity as C
from ibu_tpu_torch.ops.u64 import U64_MASK
from ibu_tpu_torch.parallel.device import STATS_MAP_REDUCE, finalize_stats

SEED = 13
RECORD_BYTES = 24


def make_buffers(b: int, buffers: int) -> list[np.ndarray]:
    """The reference's buffers: ``(b, 6)`` uint32 words from ``default_rng(13)``."""
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, 2**32, (b, 6), dtype=np.uint64).astype(np.uint32)
            for _ in range(buffers)]


def fold(state: dict, placed: list, k: int) -> dict:
    """``STATS_MAP_REDUCE.update`` folded ``k`` times over ``placed`` from
    ``state``, cycling the batches; the state stays on the device."""
    for i in range(k):
        state = STATS_MAP_REDUCE.update(state, placed[i % len(placed)])
    return state


def numpy_stats(hosts: list[np.ndarray]) -> dict:
    """The oracle: count and per-field sums mod 2^64 of every buffer."""
    sums = [0, 0, 0]
    for h in hosts:
        words = C.wire(h).view(np.uint64)
        for f in range(3):
            sums[f] += int(words[:, f].sum(dtype=np.uint64))
    return {"count": sum(len(h) for h in hosts), "barcode_sum": sums[0] & U64_MASK,
            "umi_sum": sums[1] & U64_MASK, "index_sum": sums[2] & U64_MASK}


def run(device, b: int, buffers: int, ks, reps: int) -> dict:
    C.log(f"engine_capacity_lab: {C.device_name(device)}, {buffers} resident buffers x "
          f"{b * RECORD_BYTES / 1e6:.1f} MB")
    hosts = make_buffers(b, buffers)
    placed = C.place(hosts, device)
    state = fold(STATS_MAP_REDUCE.init(device), placed, buffers)
    got = finalize_stats(STATS_MAP_REDUCE.finalize(state))
    C.require(got == numpy_stats(hosts), f"the fold {got} equals the numpy sums")
    C.log("  oracle ok")

    def prepare(k):
        state = STATS_MAP_REDUCE.init(device)
        return lambda: fold(state, placed, k)

    times = C.chain_times(prepare, ks, reps, device)
    nbytes = b * RECORD_BYTES
    out = {
        "batch_records": b,
        "buffers": buffers,
        "MB": nbytes / 1e6,
        "best_s": times and times["best_s"],
        "best_ms": times and times["best_ms"],
        "median_ms": times and times["median_ms"],
        **C.rates(times, b, nbytes, nbytes, device),
    }
    if times:
        C.log(f"  {out['per_batch_ms']:.4f} ms/batch = {out['GB_s']:.1f} GB/s device-side, "
              f"{out['pct_of_bound']:.1f}% of the bound")
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ibu_tpu_torch.labs.engine_capacity_lab",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--batch-records", type=int, default=1 << 20)
    ap.add_argument("--buffers", type=int, default=8)
    ap.add_argument("--k", nargs=2, type=int, default=(16, 64))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu: the checks, no timing")
    args = ap.parse_args(argv)
    if args.k[1] <= args.k[0]:
        ap.error(f"--k must be increasing, got {args.k}")
    device = C.lab_device(args.device, ap.prog)
    if device is None:
        return 2
    C.emit(run(device, args.batch_records, args.buffers, args.k, args.reps), device, C.EVENTS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
