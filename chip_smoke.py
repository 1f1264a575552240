#!/usr/bin/env python3
"""Smoke run of ``ibu_tpu_torch`` on one NVIDIA CUDA card.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure raises and exits non-zero:

1. require a CUDA card and print its name and power limit (``nvidia-smi``);
2. build the CUDA codec kernels from ``ibu_tpu_torch/csrc`` with ``nvcc``;
3. hold each kernel against its plain torch version on the card, exactly:
   every field length in {1, 15, 16, 17, 31, 32}, a record count that is not
   a multiple of the block, lowercase input, all-T 32-base fields and
   indices with bit 63 set;
4. drive the record pipeline at 10M records of 16-base barcodes and 12-base
   UMIs: encode → decode, a 1M-record encode+sort to a file byte-identical to
   a numpy oracle, decode of that file, and device file statistics of a
   10M-record file against the native engine and numpy. Both kernels' launch
   counters are zeroed just before this phase and must be positive after it;
5. time each kernel and its plain version at 10M records with CUDA events
   over distinct inputs, and check the two agree at that size.

The second-to-last line is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ibu_tpu import Header, MmapReader, Writer, native
from ibu_tpu_torch import pipelines as PL
from ibu_tpu_torch.ops import _build
from ibu_tpu_torch.ops import codec as C
from ibu_tpu_torch.ops import codec_cuda as K

N_MAIN = 10_000_000
N_SORTED = 1_000_000
N_CHECK = 100_003  # not a multiple of the 256-thread block
BC_LEN, UMI_LEN = 16, 12
#: device bytes per bc16/umi12 record, each way: 16 + 12 + 8 in, 24 out
BYTES_PER_RECORD = 60
LENGTHS = (1, 15, 16, 17, 31, 32)
SEED = 0
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
ROOT = Path(__file__).resolve().parent


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def card_rows(n: int, L: int, gen: torch.Generator, card, alphabet=b"ACGT"):
    table = torch.frombuffer(bytearray(alphabet), dtype=torch.uint8).to(card)
    return table[torch.randint(0, len(alphabet), (n, L), generator=gen, device=card)]


def card_words(n: int, gen: torch.Generator, card, cols=()):
    """Random int64 words over the full 64-bit range, from two 32-bit halves."""
    shape = (n, *cols)
    lo = torch.randint(0, 1 << 32, shape, generator=gen, device=card, dtype=torch.int64)
    hi = torch.randint(0, 1 << 32, shape, generator=gen, device=card, dtype=torch.int64)
    return (hi << 32) | lo


def max_abs_err(got, want) -> float:
    """Largest |got - want| over the outputs, exact for int64 bits."""
    err = 0
    for a, b in zip(got, want):
        require(a.shape == b.shape and a.dtype == b.dtype, "kernel and plain shapes agree")
        ne = (a != b).nonzero()
        if ne.numel():
            av = [int(v) for v in a[tuple(ne[:1000].T)].tolist()]
            bv = [int(v) for v in b[tuple(ne[:1000].T)].tolist()]
            err = max(err, max(abs(x - y) for x, y in zip(av, bv)))
    return float(err)


def check_kernels(card, n: int) -> int:
    """Phase 3: every check synchronises and must agree exactly."""
    gen = torch.Generator(device=card).manual_seed(SEED)
    cases = [(L, UMI_LEN) for L in LENGTHS] + [(BC_LEN, L) for L in LENGTHS]
    count = 0

    def encode_case(name, bc, umi, idx):
        nonlocal count
        err = max_abs_err([K.encode_records(bc, umi, idx)], [K.plain_encode_records(bc, umi, idx)])
        torch.cuda.synchronize()
        require(err == 0.0, f"encode {name}: max_abs_err {err}")
        count += 1

    def decode_case(name, records, bc_len, umi_len):
        nonlocal count
        err = max_abs_err(
            K.decode_records(records, bc_len, umi_len),
            K.plain_decode_records(records, bc_len, umi_len),
        )
        torch.cuda.synchronize()
        require(err == 0.0, f"decode {name}: max_abs_err {err}")
        count += 1

    for bc_len, umi_len in cases:
        name = f"bc{bc_len}/umi{umi_len} n={n}"
        encode_case(name, card_rows(n, bc_len, gen, card), card_rows(n, umi_len, gen, card),
                    card_words(n, gen, card))
        decode_case(name, card_words(n, gen, card, (3,)), bc_len, umi_len)
    lower = card_rows(n, 20, gen, card, b"acgt")
    encode_case("lowercase", lower, card_rows(n, 10, gen, card, b"ACGTacgt"),
                card_words(n, gen, card))
    upper, _, _ = K.decode_records(K.encode_records(lower, lower[:, :10].contiguous(),
                                                    card_words(n, gen, card)), 20, 10)
    require(torch.equal(upper, lower - 32), "lowercase decodes to uppercase")
    t32 = torch.full((n, 32), ord("T"), dtype=torch.uint8, device=card)
    ones = torch.full((n,), -1, dtype=torch.int64, device=card)
    encode_case("all-T32", t32, t32, ones)
    require(bool((K.encode_records(t32, t32, ones) == -1).all()), "all-T32 sets bit 63")
    decode_case("all-ones", torch.full((n, 3), -1, dtype=torch.int64, device=card), 32, 32)
    bit63 = card_words(n, gen, card) | torch.iinfo(torch.int64).min
    encode_case("bit-63 index", card_rows(n, BC_LEN, gen, card),
                card_rows(n, UMI_LEN, gen, card), bit63)
    torch.cuda.synchronize()
    return count


def timed(step: str, fn):
    t0 = time.perf_counter()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    log(f"main path: {step}: {time.perf_counter() - t0:.3f} s")
    return out


def main_path(card, n_main: int, n_sorted: int, workdir: Path) -> None:
    """Phase 4: the port's entry points, as a user calls them."""
    rng = np.random.default_rng(SEED)
    bc = ACGT[rng.integers(0, 4, (n_main, BC_LEN), dtype=np.uint8)]
    umi = ACGT[rng.integers(0, 4, (n_main, UMI_LEN), dtype=np.uint8)]
    idx = rng.integers(0, 1 << 64, size=n_main, dtype=np.uint64)
    oracle = PL.encode_batch(bc, umi, idx, engine="host")

    K.encode_records.launches = 0
    K.decode_records.launches = 0
    records = timed(f"encode_batch {n_main}", lambda: PL.encode_batch(bc, umi, idx, device=card))
    require(records.tobytes() == oracle.tobytes(), "encode_batch equals the host codec")
    got = timed(f"decode_batch {n_main}", lambda: PL.decode_batch(records, BC_LEN, UMI_LEN, device=card))
    for a, b, what in zip(got, (bc, umi, idx), ("barcodes", "UMIs", "indices")):
        require(np.array_equal(a, b), f"decode_batch gives back the {what}")

    sorted_path = str(workdir / "sorted.ibu")
    oracle_path = str(workdir / "oracle.ibu")
    timed(f"encode_sorted_file {n_sorted}",
          lambda: PL.encode_sorted_file(sorted_path, bc[:n_sorted], umi[:n_sorted], device=card))
    want = oracle[:n_sorted].copy()
    want["index"] = np.arange(n_sorted, dtype=np.uint64)
    want = np.sort(want, order=("barcode", "umi", "index"))
    header = Header.new(BC_LEN, UMI_LEN)
    header.set_sorted()
    with Writer.from_path(oracle_path, header) as w:
        w.write_batch(want)
    require(Path(sorted_path).read_bytes() == Path(oracle_path).read_bytes(),
            "encode_sorted_file is byte-identical to the numpy oracle")
    hdr, dbc, dumi, didx = timed(f"decode_file {n_sorted}", lambda: PL.decode_file(sorted_path, device=card))
    require(hdr.sorted() and (hdr.bc_len, hdr.umi_len) == (BC_LEN, UMI_LEN), "decode_file header")
    require(np.array_equal(dbc, C.np_unpack(want["barcode"], BC_LEN)), "decode_file barcodes")
    require(np.array_equal(dumi, C.np_unpack(want["umi"], UMI_LEN)), "decode_file UMIs")
    require(np.array_equal(didx, want["index"]), "decode_file indices")

    stats_path = str(workdir / "stats.ibu")
    with Writer.from_path(stats_path, Header.new(BC_LEN, UMI_LEN)) as w:
        w.write_batch(records)
    stats = timed(f"file_stats device {n_main}",
                  lambda: PL.file_stats(stats_path, engine="device", device=card))
    nat = native.checksum_parallel(stats_path, MmapReader(stats_path).len())
    np_sums = tuple(int(records[f].sum(dtype=np.uint64)) for f in ("barcode", "umi", "index"))
    got_sums = (stats["barcode_sum"], stats["umi_sum"], stats["index_sum"])
    log(f"main path: file_stats {stats}")
    require(stats["count"] == n_main, "file_stats count")
    require(got_sums == nat, f"file_stats sums {got_sums} equal the native engine {nat}")
    require(got_sums == np_sums, f"file_stats sums equal numpy {np_sums}")


def time_pair(kernel, plain, sets, iters: int, plain_iters: int):
    """Mean ms per call of ``kernel`` and ``plain`` cycling over distinct
    input sets, CUDA events around each run of calls."""

    def run(fn, k):
        fn(*sets[0])
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(k):
            fn(*sets[i % len(sets)])
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / k

    return run(kernel, iters), run(plain, plain_iters)


def time_kernels(card, n: int, launches: dict) -> list[dict]:
    """Phase 5: kernel and plain version at the main path's shapes."""
    gen = torch.Generator(device=card).manual_seed(SEED + 1)
    enc_sets = [
        (card_rows(n, BC_LEN, gen, card), card_rows(n, UMI_LEN, gen, card), card_words(n, gen, card))
        for _ in range(3)
    ]
    dec_sets = [(K.encode_records(*s), BC_LEN, UMI_LEN) for s in enc_sets]
    enc_err = max_abs_err([K.encode_records(*enc_sets[0])], [K.plain_encode_records(*enc_sets[0])])
    dec_err = max_abs_err(K.decode_records(*dec_sets[0]), K.plain_decode_records(*dec_sets[0]))
    torch.cuda.synchronize()
    require(enc_err == 0.0 and dec_err == 0.0, f"kernels agree at n={n}")
    out = []
    for name, kernel, plain, sets, err, line in (
        ("encode_records", K.encode_records, K.plain_encode_records, enc_sets, enc_err, 252),
        ("decode_records", K.decode_records, K.plain_decode_records, dec_sets, dec_err, 327),
    ):
        ms, plain_ms = time_pair(kernel, plain, sets, iters=20, plain_iters=5)
        gbps = BYTES_PER_RECORD * n / (ms * 1e6)
        plain_gbps = BYTES_PER_RECORD * n / (plain_ms * 1e6)
        log(f"timing: {name} n={n}: kernel {ms:.4f} ms ({gbps:.1f} GB/s at "
            f"{BYTES_PER_RECORD} B/record), plain {plain_ms:.4f} ms ({plain_gbps:.1f} GB/s)")
        out.append({
            "name": name,
            "route": "cuda",
            "source": "ibu_tpu_torch/csrc/codec.cu",
            "replaces": f"ibu_tpu/ops/codec_pallas.py:{line}",
            "launches": launches[name],
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "gbps": gbps,
            "plain_gbps": plain_gbps,
        })
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    card = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    log(f"build: {lib.name} with {_build.find_nvcc()}: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    n_checks = check_kernels(card, N_CHECK)
    log(f"kernel checks: {n_checks} exact matches against the plain versions "
        f"({time.perf_counter() - t0:.2f} s)")

    workdir = ROOT / "build" / "chip_smoke"
    workdir.mkdir(parents=True, exist_ok=True)
    try:
        main_path(card, N_MAIN, N_SORTED, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    launches = {
        "encode_records": K.encode_records.launches,
        "decode_records": K.decode_records.launches,
    }
    log(f"launches on the main path: {launches}")
    require(all(v > 0 for v in launches.values()), "every kernel ran on the main path")

    kernels = time_kernels(card, N_MAIN, launches)
    torch.cuda.synchronize()
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
