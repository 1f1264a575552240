"""Device-side capacity of ``DeviceHistogram`` (transport excluded).

    python -m ibu_tpu_torch.labs.histogram_capacity_lab [--batch-records 1048576]
        [--buffers 8] [--barcodes 4096] [--k 8 32] [--reps 3] [--capacity 65536]
        [--max-uniques 16384] [--merge-every 8] [--bc16] [--spill on|off] [--sorted]
        [--device cpu]

The counterpart of ``tools/histogram_capacity_lab.py``, and the histogram
sibling of :mod:`.engine_capacity_lab`. ``--buffers`` distinct batches from
``default_rng(17)`` (barcodes below ``--barcodes``, UMI and index below 2^16;
with ``--sorted``, each batch sorted by barcode and the histogram built with
``assume_sorted=True``) are placed on the card beforehand; then
:meth:`ibu_tpu_torch.parallel.device.DeviceHistogram.update_placed` (the
batch's histogram into a staging row, and every ``--merge-every`` batches the
group-sum merge into the device table, with the overflow lane when ``--spill
on``) is chained ``k`` times, cycling the buffers, ending on the table's
counts. The chain runs under ``torch.cuda.set_sync_debug_mode("error")``, so
a step that waits on the card fails the lab instead of hiding in the time.
Beside it: one-key ``torch.sort`` of the same barcode column, the floor of
any sort-based histogram (``sort_ms``).

The oracle, checked before anything is timed: one fold over every buffer,
``finalize()``, equals ``np.unique`` over all their barcodes. Timing: CUDA
events around each chain (:mod:`._capacity`). ``GB_s`` counts the 24-byte
wire records; the bound counts what a step must move: the 8-byte barcode of
each record read, and one staged row of ``--max-uniques`` keys and counts
written. The JAX lab's ``--shard-impl scatter`` is not here: its round-2
formulation has no counterpart in the port. One JSON line on stdout.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ibu_tpu_torch.labs import _capacity as C
from ibu_tpu_torch.parallel.device import DeviceHistogram

SEED = 17
RECORD_BYTES = 24


def make_buffers(b: int, buffers: int, barcodes: int, sort: bool) -> list[np.ndarray]:
    """The reference's ``(b, 6)`` uint32 batches from ``default_rng(17)``."""
    rng = np.random.default_rng(SEED)
    hosts = []
    for _ in range(buffers):
        raw = np.zeros((b, 6), dtype=np.uint32)
        raw[:, 0] = rng.integers(0, barcodes, b)  # bc_lo
        raw[:, 2] = rng.integers(0, 1 << 16, b)  # umi_lo
        raw[:, 4] = rng.integers(0, 1 << 16, b)  # idx_lo
        if sort:
            raw = raw[np.argsort(raw[:, 0], kind="stable")]
        hosts.append(raw)
    return hosts


def numpy_histogram(hosts: list[np.ndarray]) -> dict[int, int]:
    vals, counts = np.unique(np.concatenate([h[:, 0] for h in hosts]).astype(np.uint64),
                             return_counts=True)
    return dict(zip(vals.tolist(), counts.tolist()))


def fold(hist: DeviceHistogram, placed: list, k: int, bc16: bool) -> DeviceHistogram:
    """``hist`` updated ``k`` times, cycling ``placed``."""
    for i in range(k):
        hist.update_placed(placed[i % len(placed)], bc16=bc16)
    return hist


def run(device, args) -> dict:
    b = args.batch_records
    C.log(f"histogram_capacity_lab: {C.device_name(device)}, {args.buffers} resident buffers x "
          f"{b * RECORD_BYTES / 1e6:.1f} MB, {args.barcodes} barcodes")
    hosts = make_buffers(b, args.buffers, args.barcodes, args.sorted)
    placed = C.place(hosts, device)

    def make():
        return DeviceHistogram(capacity=args.capacity, max_uniques_per_shard=args.max_uniques,
                               merge_every=args.merge_every, spill=args.spill == "on",
                               assume_sorted=args.sorted, device=device)

    got = fold(make(), placed, args.buffers, args.bc16).finalize()
    want = numpy_histogram(hosts)
    C.require(got == want, f"finalize() ({len(got)} barcodes) equals np.unique ({len(want)})")
    C.log("  oracle ok")

    def prepare(k):
        hist = make()
        return lambda: fold(hist, placed, k, args.bc16)._state["cnt"]

    def prepare_sort(k):
        return lambda: [torch.sort(placed[i % len(placed)][:, 0]) for i in range(k)]

    times = C.chain_times(prepare, args.k, args.reps, device, lambda: C.no_host_waits(device))
    sort_times = C.chain_times(prepare_sort, args.k, args.reps, device)
    out = {
        "bc16": bool(args.bc16),
        "sorted": bool(args.sorted),
        "spill": args.spill == "on",
        "batch_records": b,
        "buffers": args.buffers,
        "MB": b * RECORD_BYTES / 1e6,
        "barcodes": args.barcodes,
        "capacity": args.capacity,
        "max_uniques": args.max_uniques,
        "merge_every": args.merge_every,
        "best_s": times and times["best_s"],
        "best_ms": times and times["best_ms"],
        "median_ms": times and times["median_ms"],
        **C.rates(times, b, b * RECORD_BYTES, 8 * b + 16 * args.max_uniques, device),
        "sort_ms": sort_times and sort_times["best_ms"][max(args.k)],
        "sort_median_ms": sort_times and sort_times["median_ms"][max(args.k)],
    }
    if times:
        C.log(f"  {out['per_batch_ms']:.4f} ms/batch = {out['GB_s']:.1f} GB/s device-side, "
              f"{out['pct_of_bound']:.1f}% of the bound; "
              f"one-key torch.sort {out['sort_ms']:.4f} ms")
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ibu_tpu_torch.labs.histogram_capacity_lab",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--batch-records", type=int, default=1 << 20)
    ap.add_argument("--buffers", type=int, default=8)
    ap.add_argument("--barcodes", type=int, default=4096)
    ap.add_argument("--k", nargs=2, type=int, default=(8, 32))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--capacity", type=int, default=1 << 16)
    ap.add_argument("--max-uniques", type=int, default=1 << 14)
    ap.add_argument("--merge-every", type=int, default=8)
    ap.add_argument("--bc16", action="store_true",
                    help="hinted 32-bit batch sort (true for this lab's data: barcodes < 2^32)")
    ap.add_argument("--spill", choices=("on", "off"), default="on",
                    help="the overflow-lane merge (on) or the strict merge (off)")
    ap.add_argument("--sorted", action="store_true",
                    help="buffers sorted by barcode, assume_sorted=True (order checked)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu: the checks, no timing")
    args = ap.parse_args(argv)
    if args.k[1] <= args.k[0]:
        ap.error(f"--k must be increasing, got {args.k}")
    device = C.lab_device(args.device, ap.prog)
    if device is None:
        return 2
    C.emit(run(device, args), device, C.EVENTS + ", under sync debug mode 'error'")
    return 0


if __name__ == "__main__":
    sys.exit(main())
