"""Device-side capacity of the molecule counts: UMI deduplication and the
count matrix on resident batches (transport excluded).

    python -m ibu_tpu_torch.labs.molcount_capacity_lab [--batch-records 4194304]
        [--buffers 4] [--barcodes 2048] [--indices 64] [--k 4 16] [--reps 3]
        [--max-uniques 8192] [--max-pairs 131072] [--hints [on|off|both]] [--device cpu]

The counterpart of ``tools/molcount_capacity_lab.py``. It times
:func:`ibu_tpu_torch.ops.stats.molecule_counts` (distinct ``(barcode, umi)``
pairs per barcode) and :func:`~ibu_tpu_torch.ops.stats.pair_molecule_counts`
(distinct triples per ``(barcode, index)`` pair) over ``--buffers`` distinct
resident batches of records from ``default_rng(23)`` (barcodes below
``--barcodes``, UMIs below 2^16, indices below ``--indices``; the first batch
is the reference's one batch). Where the JAX lab threads one batch through a
``fori_loop`` with a perturbation, to defeat a memoizing backend, this lab
cycles distinct batches, timed with CUDA events around chains of ``k`` calls
(:mod:`._capacity`). ``--hints`` passes ``bc_len=16, umi_len=16`` (and
``index_bits=32`` to the pair counts), true for this data; ``both`` runs
without and with them, sharing the oracle.

The oracles, checked on the first batch before anything is timed:
``molecule_counts_np`` and ``pair_molecule_counts_np`` equal the tables and
the true distinct counts. ``GB_s`` counts the 24-byte records; the bound
counts what each function must move: the fields it groups by, read once
(16 bytes per record for the molecule counts, 24 for the pair counts), and
its tables written once. One JSON line per function and hint setting.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ibu_tpu_torch.constructs.record import make_records
from ibu_tpu_torch.labs import _capacity as C
from ibu_tpu_torch.ops.stats import (
    molecule_counts,
    molecule_counts_np,
    pair_molecule_counts,
    pair_molecule_counts_np,
    table_dict,
)

SEED = 23
RECORD_BYTES = 24


def make_batches(b: int, buffers: int, barcodes: int, indices: int) -> list[np.ndarray]:
    """Structured record batches from ``default_rng(23)``, the first the
    reference's batch."""
    rng = np.random.default_rng(SEED)
    return [make_records(rng.integers(0, barcodes, b).astype(np.uint64),
                         rng.integers(0, 1 << 16, b).astype(np.uint64),
                         rng.integers(0, indices, b).astype(np.uint64))
            for _ in range(buffers)]


def hint_kwargs(hints: bool) -> tuple[dict, dict]:
    """The molecule counts' and the pair counts' hint arguments."""
    if not hints:
        return {}, {}
    return {"bc_len": 16, "umi_len": 16}, {"bc_len": 16, "umi_len": 16, "index_bits": 32}


def functions(args, hints: bool) -> dict:
    """name → (call on one batch, the bytes it must move)."""
    mol_kw, pair_kw = hint_kwargs(hints)
    b = args.batch_records
    return {
        "molecule_counts": (lambda t: molecule_counts(t, args.max_uniques, **mol_kw),
                            16 * b + 16 * args.max_uniques),
        "pair_molecule_counts": (lambda t: pair_molecule_counts(t, args.max_pairs, **pair_kw),
                                 24 * b + 24 * args.max_pairs),
    }


def check(fns: dict, first, oracle: dict, hints: bool) -> None:
    keys, mol, nuniq = fns["molecule_counts"][0](first)
    want = oracle["molecule_counts"]
    C.require(table_dict(keys, mol) == want and int(nuniq) == len(want),
              f"molecule_counts (hints={hints}) equals molecule_counts_np")
    pair_keys, counts, npairs = fns["pair_molecule_counts"][0](first)
    want = oracle["pair_molecule_counts"]
    C.require(table_dict(pair_keys, counts) == want and int(npairs) == len(want),
              f"pair_molecule_counts (hints={hints}) equals pair_molecule_counts_np")


def run(device, args) -> list[dict]:
    b = args.batch_records
    C.log(f"molcount_capacity_lab: {C.device_name(device)}, {args.buffers} batches of {b} "
          f"records ({b * RECORD_BYTES / 1e6:.1f} MB), {args.barcodes} barcodes x "
          f"{args.indices} indices")
    batches = make_batches(b, args.buffers, args.barcodes, args.indices)
    placed = C.place(batches, device)
    oracle = {"molecule_counts": molecule_counts_np(batches[0]),
              "pair_molecule_counts": pair_molecule_counts_np(batches[0])}
    settings = {"off": [False], "on": [True], "both": [False, True]}[args.hints]
    for hints in settings:
        check(functions(args, hints), placed[0], oracle, hints)
    C.log("  oracles ok")
    out = []
    for hints in settings:
        for name, (fn, nbytes) in functions(args, hints).items():
            def prepare(k, fn=fn):
                return lambda: [fn(placed[i % len(placed)]) for i in range(k)]

            times = C.chain_times(prepare, args.k, args.reps, device)
            line = {
                "kernel": name,
                "hints": hints,
                "batch_records": b,
                "buffers": args.buffers,
                "MB": b * RECORD_BYTES / 1e6,
                "best_ms": times and times["best_ms"],
                "median_ms": times and times["median_ms"],
                **C.rates(times, b, b * RECORD_BYTES, nbytes, device),
            }
            if times:
                C.log(f"  {name} hints={hints}: {line['per_batch_ms']:.4f} ms/batch, "
                      f"{line['Mrec_s']:.0f} Mrec/s, {line['pct_of_bound']:.1f}% of the bound")
            out.append(line)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ibu_tpu_torch.labs.molcount_capacity_lab",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--batch-records", type=int, default=1 << 22)
    ap.add_argument("--buffers", type=int, default=4)
    ap.add_argument("--barcodes", type=int, default=2048)
    ap.add_argument("--indices", type=int, default=64)
    ap.add_argument("--k", nargs=2, type=int, default=(4, 16))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--max-uniques", type=int, default=1 << 13)
    ap.add_argument("--max-pairs", type=int, default=1 << 17)
    ap.add_argument("--hints", nargs="?", const="on", default="off", choices=("off", "on", "both"),
                    help="bc_len=16/umi_len=16 (+ index_bits=32 for pairs), true for this "
                         "lab's data; 'both' runs without and with")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu: the checks, no timing")
    args = ap.parse_args(argv)
    if args.k[1] <= args.k[0]:
        ap.error(f"--k must be increasing, got {args.k}")
    device = C.lab_device(args.device, ap.prog)
    if device is None:
        return 2
    for line in run(device, args):
        C.emit(line, device, C.EVENTS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
