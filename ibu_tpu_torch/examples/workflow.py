"""End-to-end single-cell workflow on the port, the counterpart of the JAX
package's ``examples/workflow.py``:

    generate reads  →  ingest (encode+sort on the device)
                    →  cells  (rank-count knee → derived allowlist)
                    →  correct (Hamming-1 vs the DERIVED allowlist, on the device)
                    →  dedup   (one record per (bc, umi) molecule; device sort)
                    →  count   (barcode × index molecule matrix)

A synthetic ground truth makes every stage checkable: reads are drawn from a
known allowlist of cell barcodes with a per-read error rate, so the called
allowlist must equal the planted one and every matrix entry must lie in the
planted molecule table. No stage is fed ground truth. The stages and their
printed counts are the reference's; ``call_cells`` and ``count_matrix`` keep
their ``"host"`` engines, as there.

Usage: python -m ibu_tpu_torch.examples.workflow [--cells 100]
       [--reads 200000] [--error-rate 0.2] [--genes 50] [--device cpu]

Without a CUDA card it exits 2 unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np

BC_LEN, UMI_LEN = 16, 12


def make_ground_truth(rng, cells, genes, reads, error_rate):
    """Plant molecules, expand to reads, inject single-base errors."""
    from ibu_tpu_torch.ops import codec as C

    allow = np.sort(
        rng.choice(1 << 30, size=cells, replace=False).astype(np.uint64)
    )
    # molecules: each read is (cell, umi, gene); duplicates share umi+gene
    cell_of = rng.integers(0, cells, reads)
    umi = rng.integers(0, 1 << 12, reads).astype(np.uint64)
    gene = rng.integers(0, genes, reads).astype(np.uint64)
    bc = allow[cell_of]
    # planted truth: distinct (bc, umi, gene) triples per (bc, gene). allow
    # is sorted and distinct, so the packed key (cell, gene, umi) orders the
    # triples as their (bc, gene, umi) rows do
    if cells * genes >= 1 << 52:
        raise ValueError(f"cells * genes must be under 2**52, got {cells} * {genes}")
    key = (cell_of.astype(np.uint64) * np.uint64(genes) + gene) << np.uint64(12) | umi
    pair_keys, truth_counts = np.unique(np.unique(key) >> np.uint64(12), return_counts=True)
    pair_bc = allow[pair_keys // np.uint64(genes)]
    pair_gene = pair_keys % np.uint64(genes)
    # inject errors: flip ONE base of the barcode on a fraction of reads
    nerr = int(error_rate * reads)
    pick = rng.choice(reads, size=nerr, replace=False)
    delta = (
        rng.integers(1, 4, nerr).astype(np.uint64)
        << (2 * rng.integers(0, BC_LEN, nerr).astype(np.uint64))
    )
    bc_err = bc.copy()
    bc_err[pick] ^= delta
    bc_rows = C.np_unpack(bc_err, BC_LEN)
    umi_rows = C.np_unpack(umi, UMI_LEN)
    return allow, bc_rows, umi_rows, gene, dict(
        zip(zip(pair_bc.tolist(), pair_gene.tolist()), truth_counts.tolist())
    )


def entries_outside_truth(mol_path: str, truth: dict) -> tuple[int, list]:
    """``(entries, missing)``: the number of distinct (barcode, index) pairs
    of a molecule file, and those of them the planted truth lacks."""
    from ibu_tpu_torch import MmapReader

    recs = np.asarray(MmapReader(mol_path).records)
    bc, idx = recs["barcode"], recs["index"]
    order = np.lexsort((idx, bc))
    bc, idx = bc[order], idx[order]
    first = np.ones(len(bc), dtype=bool)
    first[1:] = (bc[1:] != bc[:-1]) | (idx[1:] != idx[:-1])
    pairs = zip(bc[first].tolist(), idx[first].tolist())
    missing = [p for p in pairs if p not in truth]
    return int(first.sum()), missing


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cells", type=int, default=100)
    ap.add_argument("--genes", type=int, default=50)
    ap.add_argument("--reads", type=int, default=200_000)
    ap.add_argument("--error-rate", type=float, default=0.2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda, cuda:N or cpu (default: the current CUDA card)")
    args = ap.parse_args(argv)

    from ibu_tpu_torch.ops import codec as C
    from ibu_tpu_torch.pipelines import (
        call_cells,
        correct_file,
        count_matrix,
        dedup_file,
        encode_sorted_file,
    )
    from ibu_tpu_torch.utils.device import select_device

    device = select_device(args.device, "workflow")
    if device is None:
        return 2

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    allow, bc_rows, umi_rows, gene, truth = make_ground_truth(
        rng, args.cells, args.genes, args.reads, args.error_rate
    )
    print(f"[gen]     {args.reads} reads, {args.cells} cells, "
          f"{args.genes} genes, {len(truth)} true matrix entries "
          f"({time.perf_counter()-t0:.2f}s)")

    workdir = args.workdir or tempfile.mkdtemp(prefix="ibu_workflow_")
    raw = f"{workdir}/raw.ibu"

    t = time.perf_counter()
    encode_sorted_file(raw, bc_rows, umi_rows, index=gene, device=device)
    dt = time.perf_counter() - t
    print(f"[ingest]  encode+sort+write -> {raw} "
          f"({args.reads/dt/1e6:.1f} M reads/s, {dt:.2f}s)")

    # ordmag (not knee): at high error rates the error cloud's Poisson tail
    # hugs the cell plateau, and the parameter-free knee can admit its top
    # stragglers; order-of-magnitude with the expected cell count is exact
    # here.
    t = time.perf_counter()
    allowfile = f"{workdir}/cells.txt"
    kstats = call_cells(raw, allowfile, method="ordmag", expect=args.cells)
    with open(allowfile) as f:
        called = np.sort(C.encode_seqs([l.strip() for l in f if l.strip()]))
    dt = time.perf_counter() - t
    print(f"[cells]   {kstats['method']} called {kstats['cells']} cells of "
          f"{kstats['barcodes']} barcodes (threshold >= "
          f"{kstats['threshold']} reads, {dt:.2f}s)")
    if not np.array_equal(called, allow):
        raise SystemExit(
            f"FAIL: knee allowlist != planted allowlist "
            f"({len(called)} called vs {len(allow)} planted)"
        )

    t = time.perf_counter()
    fixed = f"{workdir}/corrected.ibu"
    cstats = correct_file(raw, fixed, called, device=device)
    dt = time.perf_counter() - t
    print(f"[correct] {cstats['exact']} exact + {cstats['corrected']} "
          f"corrected, {cstats['dropped']} dropped "
          f"({args.reads/dt/1e6:.1f} M reads/s, {dt:.2f}s)")

    t = time.perf_counter()
    mol = f"{workdir}/molecules.ibu"
    dstats = dedup_file(fixed, mol, assume_sorted=False, device=device)
    dt = time.perf_counter() - t
    print(f"[dedup]   {dstats['records']} reads -> {dstats['molecules']} "
          f"molecules across {dstats['barcodes']} cells ({dt:.2f}s)")

    t = time.perf_counter()
    stats = count_matrix(mol, f"{workdir}/counts")
    dt = time.perf_counter() - t
    print(f"[count]   {stats['barcodes']} x {stats['indices']} matrix, "
          f"{stats['entries']} entries, {stats['molecules']} molecules "
          f"({dt:.2f}s)")

    # ambiguously-corrected reads drop, which can only LOSE molecules: every
    # surviving entry must be in the planted truth
    entries, missing = entries_outside_truth(mol, truth)
    if missing:
        raise SystemExit(f"FAIL: {len(missing)} matrix entries not in the "
                         "planted truth")
    coverage = entries / len(truth)
    print(f"[verify]  all {entries} surviving entries match the planted "
          f"truth ({coverage:.1%} coverage; losses are dropped ambiguous "
          "corrections)")
    print(f"workdir: {workdir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
