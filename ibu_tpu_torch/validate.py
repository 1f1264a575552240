"""On-card validation matrix: oracle checks against the CUDA kernels.

Counterpart of :mod:`ibu_tpu.validate`. The CPU tests hold the plain torch
versions against the JAX package; this module runs the same 27 oracle checks,
with the same seeds, sizes, names and order, on whatever device it is given,
so on a CUDA card it checks the compiled kernels and the device aggregations
themselves. The oracles are the numpy copies in :mod:`ibu_tpu_torch.ops`.

    python -m ibu_tpu_torch.validate [--device cuda|cpu] [--out PATH]

prints PASS/FAIL per check, writes the pass/fail record (default
``build/TORCH_VALIDATE.json``) and exits 1 on any failure. It runs on the
card; with no card it exits 2 unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ibu_tpu_torch.constructs.record import make_records
from ibu_tpu_torch.ops import codec as C
from ibu_tpu_torch.ops.codec_cuda import (
    decode_planes,
    decode_records,
    encode_planes,
    encode_records,
)
from ibu_tpu_torch.ops.stats import (
    barcode_histogram,
    barcode_histogram_np,
    checksum_records,
    checksum_records_np,
    molecule_counts,
    molecule_counts_np,
    pair_molecule_counts,
    pair_molecule_counts_np,
    sort_records,
    table_dict,
)
from ibu_tpu_torch.ops.u64 import (
    records_from_tensor,
    records_to_tensor,
    to_device,
    to_host,
    u64_as_int64,
)
from ibu_tpu_torch.parallel.device import DeviceHistogram
from ibu_tpu_torch.utils.device import resolve_device, select_device

DEFAULT_ARTIFACT = Path(__file__).resolve().parents[1] / "build" / "TORCH_VALIDATE.json"


def _random_rows(n, L, seed=0, lowercase=False):
    rng = np.random.default_rng(seed)
    al = np.frombuffer(b"acgt" if lowercase else b"ACGT", dtype=np.uint8)
    return al[rng.integers(0, 4, size=(n, L))]


def _words(t: torch.Tensor) -> np.ndarray:
    """int64 tensor → uint64 host array of the same bits."""
    return to_host(t).view(np.uint64)


def run_matrix(progress=None, device: str | torch.device | None = None) -> list[tuple[str, bool]]:
    """Run every oracle check on ``device`` (default: the current CUDA card;
    ``"cpu"`` runs the plain torch versions). Returns ``[(check_name, passed), ...]``;
    ``progress`` is called with each ``PASS``/``FAIL`` line as it lands."""
    device = resolve_device(device)
    results: list[tuple[str, bool]] = []

    def check(name: str, ok: bool) -> None:
        results.append((name, bool(ok)))
        if progress is not None:
            progress(f"{'PASS' if ok else 'FAIL'} {name}")

    def rows_on(rows: np.ndarray) -> torch.Tensor:
        return to_device(np.ascontiguousarray(rows), device)

    # codec matrix: boundary lengths incl. the hi-word and bit-63 paths
    for L in (1, 15, 16, 17, 31, 32):
        rows = _random_rows(3000, L, seed=L)
        words = encode_planes(rows_on(rows))
        check(f"encode_planes L={L}", np.array_equal(_words(words), C.np_pack(rows)))
        back = decode_planes(words, L)
        check(f"decode_planes L={L}", np.array_equal(to_host(back), rows))

    # all-T 32-base: bit 63 set
    words = _words(encode_planes(rows_on(np.full((256, 32), ord("T"), np.uint8))))
    check("bit63 all-T32", bool((words == 0xFFFFFFFFFFFFFFFF).all()))

    # lowercase
    rows = _random_rows(1000, 12, seed=9, lowercase=True)
    check("lowercase encode", np.array_equal(_words(encode_planes(rows_on(rows))), C.np_pack(rows)))

    # fused record kernels + salt
    n = 5000
    bc_rows = _random_rows(n, 16, seed=1)
    umi_rows = _random_rows(n, 12, seed=2)
    idx = np.arange(n, dtype=np.uint64) * np.uint64(11)
    fused_in = (rows_on(bc_rows), rows_on(umi_rows), to_device(u64_as_int64(idx), device))
    dev_recs = encode_records(*fused_in)
    recs = records_from_tensor(dev_recs)
    check("fused encode barcode", np.array_equal(recs["barcode"], C.np_pack(bc_rows)))
    check("fused encode umi", np.array_equal(recs["umi"], C.np_pack(umi_rows)))
    check("fused encode index", np.array_equal(recs["index"], idx))

    srecs = records_from_tensor(encode_records(*fused_in, salt=0xA5A5A5A5))
    lo = (idx & np.uint64(0xFFFFFFFF)) ^ np.uint64(0xA5A5A5A5)
    hi = (idx >> np.uint64(32)) ^ np.uint64(0xA5A5A5A5)
    check("salt xor on index", np.array_equal(srecs["index"], (hi << np.uint64(32)) | lo))

    bc_d, umi_d, idx_d = decode_records(dev_recs, 16, 12)
    check(
        "fused decode roundtrip",
        np.array_equal(to_host(bc_d), bc_rows)
        and np.array_equal(to_host(umi_d), umi_rows)
        and np.array_equal(_words(idx_d), idx),
    )

    # device sort vs host sort (with ties)
    rng = np.random.default_rng(4)
    records = make_records(
        rng.integers(0, 32, 10_001, dtype=np.uint64),
        rng.integers(0, 32, 10_001, dtype=np.uint64),
        rng.integers(0, 1 << 63, 10_001, dtype=np.uint64),
    )
    got = records_from_tensor(sort_records(records_to_tensor(records, device)))
    check("device sort", np.array_equal(got, np.sort(records, order=("barcode", "umi", "index"))))

    # hinted sort (dropped hi words): the common bc16/umi12/idx<2^32 case
    hinted_rec = make_records(
        rng.integers(0, 1 << 32, 10_001, dtype=np.uint64),
        rng.integers(0, 1 << 24, 10_001, dtype=np.uint64),
        rng.permutation(10_001).astype(np.uint64),
    )
    got_h = records_from_tensor(
        sort_records(records_to_tensor(hinted_rec, device), bc_len=16, umi_len=12, index_bits=32)
    )
    check(
        "device sort (hinted 3-op)",
        np.array_equal(got_h, np.sort(hinted_rec, order=("barcode", "umi", "index"))),
    )

    # checksums at u64 extremes
    ext = make_records(
        np.full(70_000, 0xFFFFFFFFFFFFFFFF, dtype=np.uint64),
        rng.integers(0, 1 << 63, 70_000, dtype=np.uint64),
        np.arange(70_000, dtype=np.uint64),
    )
    check("checksum extremes", checksum_records(records_to_tensor(ext, device)) == checksum_records_np(ext))

    # histogram
    hrec = make_records(
        rng.integers(0, 300, 20_000, dtype=np.uint64),
        rng.integers(0, 1 << 40, 20_000, dtype=np.uint64),
        np.arange(20_000, dtype=np.uint64),
    )
    keys, counts, n_uniq = barcode_histogram(records_to_tensor(hrec, device), max_uniques=1024)
    want = barcode_histogram_np(hrec)
    check("device histogram", table_dict(keys, counts) == want and int(n_uniq) == len(want))

    # sorted-input path: the order verified on the device
    srec = np.sort(hrec, order=("barcode", "umi", "index"))
    hfast = DeviceHistogram(capacity=1024, max_uniques_per_shard=1024, assume_sorted=True, device=device)
    check("sorted histogram fast path", hfast.run(iter([srec])) == want)
    hlie = DeviceHistogram(capacity=1024, max_uniques_per_shard=1024, assume_sorted=True, device=device)
    hlie.update(hrec)  # unsorted data under the sorted claim
    try:
        hlie.finalize()
        check("sorted-path order detection", False)
    except ValueError:
        check("sorted-path order detection", True)

    # UMI dedup: distinct (bc, umi) pairs per barcode
    mrec = make_records(
        rng.integers(0, 200, 30_000, dtype=np.uint64),
        rng.integers(0, 64, 30_000, dtype=np.uint64),
        rng.integers(0, 1 << 50, 30_000, dtype=np.uint64),
    )
    m_keys, mol, m_uniq = molecule_counts(records_to_tensor(mrec, device), max_uniques=1024)
    m_want = molecule_counts_np(mrec)
    check("device molecule counts", table_dict(m_keys, mol) == m_want and int(m_uniq) == len(m_want))

    # count matrix: distinct triples per (bc, idx) pair, with full-u64-range
    # barcodes and indices so the hi words of the sort keys matter
    bpool = rng.integers(0, 1 << 64, 150, dtype=np.uint64)
    ipool = rng.integers(0, 1 << 64, 40, dtype=np.uint64)
    prec = make_records(
        bpool[rng.integers(0, 150, 20_000)],
        rng.integers(0, 16, 20_000, dtype=np.uint64),
        ipool[rng.integers(0, 40, 20_000)],
    )
    pair_keys, pcounts, num_pairs = pair_molecule_counts(records_to_tensor(prec, device), max_pairs=8192)
    p_want = pair_molecule_counts_np(prec)
    check(
        "device pair molecule counts",
        table_dict(pair_keys, pcounts) == p_want and int(num_pairs) == len(p_want),
    )
    return results


def write_artifact(
    path: str | Path,
    results: list[tuple[str, bool]],
    device: str | torch.device | None = None,
) -> dict:
    """Write the machine-readable pass/fail record of a :func:`run_matrix`
    run on ``device``."""
    device = resolve_device(device)
    if device.type == "cuda":
        devices = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
    else:
        devices = ["cpu"]
    record = {
        "backend": device.type,
        "devices": devices,
        "passed": sum(ok for _, ok in results),
        "failed": sum(not ok for _, ok in results),
        "checks": {name: ok for name, ok in results},
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(record, indent=1) + "\n")
    return record


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ibu_tpu_torch.validate", description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu: the plain torch versions; without a card "
                         "and without --device cpu the command exits 2")
    ap.add_argument("--out", default=str(DEFAULT_ARTIFACT), help="pass/fail record to write")
    args = ap.parse_args(argv)
    device = select_device(args.device, ap.prog)
    if device is None:
        return 2
    results = run_matrix(progress=lambda line: print(line, flush=True), device=device)
    record = write_artifact(args.out, results, device)
    print(f"{record['passed']}/{len(results)} checks passed on {device} ({', '.join(record['devices'])}); "
          f"wrote {args.out}")
    return 0 if record["failed"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
