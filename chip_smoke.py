#!/usr/bin/env python3
"""Smoke run of ``ibu_tpu_torch`` on one NVIDIA CUDA card.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure raises and exits non-zero:

1. require a CUDA card and print its name and power limit (``nvidia-smi``);
2. build the CUDA codec kernels from ``ibu_tpu_torch/csrc`` with ``nvcc`` and
   print ptxas's registers and spills;
3. hold each kernel against its plain torch version on the card, exactly:
   every field length in {1, 15, 16, 17, 31, 32}, a record count that is not
   a multiple of the block, lowercase input, all-T 32-base fields, indices
   with bit 63 set, a misaligned row view, and the fused kernels salted with
   0xA5A5A5A5 and 0xFFFFFFFF;
4. drive the record pipeline at 10M records of 16-base barcodes and 12-base
   UMIs: encode → decode, a 1M-record encode+sort to a file byte-identical to
   a numpy oracle, decode of that file, and device file statistics of a
   10M-record file against the native engine and numpy. Both record kernels'
   launch counters are zeroed just before this phase and must be positive
   after it;
5. run the validation matrix (:func:`ibu_tpu_torch.validate.run_matrix`) on
   the card: 27 of 27 checks, named as in ``TPU_VALIDATE.json``. All four
   kernels' launch counters are zeroed just before it and must be positive
   after it;
6. drive the histogram path at 10M bc16/umi12 records with Zipf-distributed
   barcodes: ``stream_file_histogram`` and ``barcode_counts(engine="device")``
   on the unsorted file and on a sorted copy (the fast path) against the host
   engine and numpy, the spill path and the strict capacity error, a lying
   sorted flag, a gzip stream into ``DeviceHistogram.run``, and the molecule
   and pair molecule counts of 1M records against their numpy oracles;
7. time each kernel and its plain version at 10M records with CUDA events
   over distinct inputs, and check the two agree at that size;
8. run both codec labs (:mod:`ibu_tpu_torch.labs.sol_lab` and
   :mod:`ibu_tpu_torch.labs.kernel_lab`) at 10M records: every variant and
   layout checked exactly against the host oracle, then timed, with the copy
   floor line. The six lab kernels' launch counters are zeroed just before
   the labs run and must be positive after them; then every mode of every lab
   kernel is held exactly against its plain version at 10M records over all
   byte values, and timed beside it;
9. run the radix-sort lab (:mod:`ibu_tpu_torch.labs.sort_lab`) at 2^24
   keys: its three kernels checked exactly against the numpy oracles, then
   timed beside ``torch.sort`` and the production three-key sort, with the
   verdict line. The three kernels' launch counters are zeroed just before the
   lab runs and must be positive after it; then each kernel is held exactly
   against its plain version on the lab's keys, on keys that all share one low
   byte and on 16384 keys, the rank kernels also on
   :data:`~ibu_tpu_torch.labs.sort_lab.RANK_CASES` and the store on
   :data:`~ibu_tpu_torch.labs.sort_lab.STORE_CASES`, each at 2^24 keys and at 8
   and 24 tiles, and timed beside it, with its device time from
   ``torch.profiler``;
10. run the single-cell workflow after ingest at 10M reads (bc16/umi12, 3,000
    cells, 20,000 genes as the index, error rate 0.2, made by
    :func:`ibu_tpu_torch.examples.workflow.make_ground_truth`): ingest with
    ``encode_sorted_file``, ``call_cells(engine="device")`` (the called
    allowlist must equal the planted one), ``correct_file`` on the card (file
    and statistics equal to ``device="cpu"``), ``sort_file_device`` of the
    corrected file (byte-identical to ``native.sort_file``'s), ``dedup_file``
    of the unsorted corrected file, sorted by ``native.sort_file`` as in the
    reference (byte-identical to a numpy statement of the rewrite) and
    ``count_matrix(engine="device")`` (byte-identical to ``engine="host"``),
    every matrix entry in the planted truth. The codec kernels' launch
    counters are zeroed just before the phase; ``encode_records``' must be
    positive after it. Each stage's wall time is printed, the
    ``torch.profiler`` device time of one more run of ``correct_file``, and
    ``cProfile``'s heaviest host functions of one more run of it and of
    ``dedup_file``;
11. drive FASTQ → IBU → FASTQ at 5M reads (bc16/umi12): a sorted 5M-record
    file; both record kernels held exactly against their plain versions on
    that file's records at every batch shape this path and phase 12's
    ``decode`` give them (a 2^20-row export batch, the export's tail batch, a
    200,000-row ingest batch, a ``Reader`` batch of
    :data:`~ibu_tpu_torch.io.reader.DEFAULT_BUFFER_RECORDS` rows and the
    ``Reader``'s tail batch);
    ``export_fastq`` to a FASTQ (held against a numpy statement on its first
    and its last 1M reads, the last spanning a batch boundary and the tail
    batch, and against 83 bytes per read) and ``ingest_fastq`` back, under
    ``IBU_AUTO_ENGINE=device`` with the codec kernels' launch counters zeroed
    just before each call: ``decode_records`` must launch once per 2^20-record
    batch and ``encode_records`` once per 200,000-read batch, and the ingested
    file must equal the source byte for byte with ``arange`` as its index
    column. The same two calls under ``IBU_AUTO_ENGINE=host`` must write the
    same bytes. Then, with the variable unset, what ``auto_codec_engine``,
    ``auto_stats_engine`` and ``auto_device_or_host`` decide on this card and
    the rates they probed; a gzip → gzip leg at 1M reads, and a gzip → zstd
    leg where the ``zstandard`` module is installed (a line says so where it
    is skipped); the file tools on
    the 5M-record file (``check_file``, ``filter_file`` against a numpy mask,
    ``lookup_barcodes``, ``split_file`` and ``concat_files`` back to the same
    bytes, ``subsample_file``, ``repair_file`` of a copy cut in mid-record,
    ``decode_tsv_block`` against a per-line statement); and the
    ``torch.profiler`` device time of one more ``export_fastq`` and
    ``ingest_fastq``;
12. drive the command line, ``python -m ibu_tpu_torch <command>``, each
    command in a new process from the root of the checkout with no
    ``--device``, on the files phases 10 and 11 leave (they keep them until
    this phase ends): ``info`` of a one-record file (the startup floor);
    ``sort``, ``info``, ``stats``, ``histogram --top 20``, ``cells --engine
    device``, ``correct``, ``dedup --assume-sorted no`` and ``count`` on the
    workflow's files, each output equal byte for byte to the same functions'
    in-process output, and ``count --engine device``, which either equals the
    host engine or refuses past ``max_pairs`` with exit 1 and the reference's
    text; ``export-fastq``, ``ingest-fastq``, ``decode`` (its first and last
    1M lines held against ``decode_tsv_block``), ``check --json``,
    ``filter``, ``lookup``, ``split``, ``merge``, ``concat``, ``subsample``
    and ``repair`` on the sorted 5M-record file, each equal to phase 11's
    results; ``decode``, ``export-fastq`` and ``ingest-fastq`` once more
    through ``ibu_tpu_torch.__main__.main`` under ``IBU_AUTO_ENGINE=device``
    with the codec kernels' launch counters zeroed before each: one
    ``decode_records`` launch per ``Reader`` batch, and one per export and
    ingest batch; and, beside the rest, ``stats --engine device`` with ``CUDA_VISIBLE_DEVICES=""``,
    which must exit 2 with one line on stderr and nothing on stdout. The
    commands run in three lanes side by side (the workflow's read-only
    commands and the file tools; the workflow's writing commands; the FASTQ
    commands and ``decode``), each lane in order, so each command's printed
    wall is taken with up to three others running;
13. drive the cohort layer (:mod:`ibu_tpu_torch.parallel.multihost`,
    :mod:`ibu_tpu_torch.parallel.sort`, :mod:`ibu_tpu_torch.data`) on an
    unsorted file of 10M bc16/umi12 records drawn from phase 10's called
    cells (random UMIs, indices under 20,000, made from the seed): a world of
    one on NCCL in this process (``sharded_sort_records``, ``sort_file_mesh``,
    ``multihost_sort_file`` with the mesh and host engines, each byte-equal to
    ``native.sort_file``; ``multihost_file_stats`` and
    ``multihost_barcode_histogram`` equal to the native and host engines),
    the group destroyed after; two ranks on the one card, one launch of this
    script as the rank workers under ``IBU_AUTO_ENGINE=device``, each running
    through ``ibu_tpu_torch.__main__.main`` with ``--distributed`` and no
    ``--device``, first the entry module's dry run
    (:func:`ibu_tpu_torch.entry.dryrun_rank` at 2^22 records a rank: encode,
    fold, ``all_reduce`` of the count, the merge, and ``sharded_sort_records``
    of the reference's records, each against numpy, ``encode_records``
    launched once a rank; it joins the cohort the commands then use), then
    ``sort --engine mesh``, ``sort --engine pod``
    (``IBU_POD_SORT_ENGINE=host``), ``stats`` and ``histogram --top 20`` on
    the cohort file; ``correct`` of phase 10's raw file (equal to phase 10's
    corrected file), ``dedup --assume-sorted no`` of that (the mesh sort inside;
    equal to phase 10's molecules), ``dedup``, ``filter`` and ``filter
    --invert`` (the first 1,000 called cells) of the sorted cohort file,
    ``count`` of phase 10's molecules (the trio equal to phase 10's host
    trio, rank 0's line to phase 12's), ``export-fastq`` of the sorted cohort
    file (the shards in rank order equal one process's export) and
    ``ingest-fastq`` of the shards concatenated (the sorted file with
    ``arange`` as its index column). Rank 0 prints what one process prints,
    rank 1 nothing; the exchange backend (Gloo: NCCL refuses two ranks on one
    card) and each rank's share of the mesh sorts are logged; both record
    kernels are held against their plain versions, before the launch, at the
    batch shapes the ranks give them (the export's 2^20 rows and each rank's
    tail, the ingest's 200,000 rows and each rank's last batch of its byte
    range), each rank reports the batch sizes it gave them, and
    ``decode_records`` and ``encode_records`` must launch once per batch on
    each rank. Three failures must end both ranks and leave no output: the
    run sort failing on rank 1, a write failing on rank 1 in ``count``, and
    ``dedup`` of a copy of the cohort file whose sorted flag lies. Each
    command's two-rank wall is printed beside one process's wall of the same
    command on the same file (``count``'s is phase 10's host count), with
    the ratio; and ``RecordLoader``
    at 2^20-record batches (sequential, ``"global"``, two ``"blocks"``
    epochs): every batch's checksum on the card equal to ``host_batches``',
    each epoch an exact permutation, the two epochs different, two shards an
    exact union, and the card's busy share of one profiled epoch (this leg
    runs first). Each leg's wall is printed;
14. run the device-capacity and feed labs (:mod:`ibu_tpu_torch.labs`), each
    through its ``main(argv)`` in this process, at sizes that keep the phase
    near a minute: ``engine_capacity_lab`` (8 resident 2^20-record batches,
    chains of 16 and 64; again at 2^22, the stream's batch),
    ``histogram_capacity_lab`` unsorted and ``--sorted --bc16`` (spill on;
    the chains under CUDA's sync debug mode at ``"error"``),
    ``molcount_capacity_lab`` at 2^22 records with the hints off and on,
    ``sort_keys_lab`` at 2^20 and 2^24 records (two input sets),
    ``stream_lab`` over two 10M-record files (all four phases, in
    ``/dev/shm``; the engine and breakdown again with the files under
    ``build/``), ``put_sweep`` at its defaults and ``put_source_lab`` at 2^20
    records and 4 puts a leg. Every lab's exact oracle checks must hold (a
    failed one raises inside the lab), each must exit 0, and each JSON line
    it prints must name this card and its timer; the lines are printed as
    they come;
15. drive the entry point (:func:`ibu_tpu_torch.entry.entry`) on
    the card: its step on the 8192-record example, then on the reference's
    draws at 10M bc16/umi12 records (config 1's size), the records held
    exactly against the plain version and the sums against numpy;
    ``encode_records``' launch counter is zeroed just before the phase and
    must count one launch per step. The walls are printed, and the script's
    total time last.

Phases 1-10 name ``engine="device"`` where they assert launches; only
``decode_file``, which takes no engine, runs under a scoped
``IBU_AUTO_ENGINE=device``, as phase 11's legs and phase 13's ranks do.

The second-to-last line is a JSON object with one entry per kernel (the four
production kernels, the six codec lab kernels with each mode's figures under
``modes``, then the three sort lab kernels). Each entry has its time
(``ms``), its plain version's (``plain_ms``), its bound (``bound_ms``: the
bytes it must move, each input read once and each output written once, over
the H100's 3350 GB/s; the sort lab's own count for its kernels, in which
``dynamic_store`` reads only the key rows its offsets select) and, where
PyTorch computes the same function, that time (``library_ms``, else null:
for ``digit_histogram`` the index pass and ``torch.bincount`` together, the
call alone under ``bincount_ms``). The last line is
``{"ok": true, "device": {...}}``. The two record kernels also carry
``fastq_launches``, their launches in phase 11's device legs,
``cli_launches``, their launches under phase 12's in-process commands, and
``cohort_launches``, their launches in each rank of phase 13's cohort
commands (the dry run's among them); ``encode_records`` also carries
``entry_launches``, its launches in phase 15 and in each rank's dry run.
"""

from __future__ import annotations

import contextlib
import filecmp
import functools
import io
import json
import os
import resource
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ibu_tpu_torch import Header, MmapReader, Reader, Writer, make_records, native
from ibu_tpu_torch import pipelines as PL
from ibu_tpu_torch.examples import workflow as WF
from ibu_tpu_torch.io.reader import DEFAULT_BUFFER_RECORDS
from ibu_tpu_torch.labs import _harness as LH
from ibu_tpu_torch.labs import _kernels as LK
from ibu_tpu_torch.labs import _sort_kernels as SK
from ibu_tpu_torch.labs import (
    engine_capacity_lab,
    histogram_capacity_lab,
    kernel_lab,
    molcount_capacity_lab,
    put_source_lab,
    put_sweep,
    sol_lab,
    sort_keys_lab,
    sort_lab,
    stream_lab,
)
from ibu_tpu_torch.ops import _build
from ibu_tpu_torch.ops import codec as C
from ibu_tpu_torch.ops import codec_cuda as K
from ibu_tpu_torch.ops import stats as S
from ibu_tpu_torch.ops.correct import variant_deltas
from ibu_tpu_torch.ops.u64 import U64_MASK, records_from_tensor, records_to_tensor
from ibu_tpu_torch.parallel import device as D
from ibu_tpu_torch.parallel import select as SEL
from ibu_tpu_torch.validate import run_matrix

try:
    import zstandard  # noqa: F401 (optional: phase 11 skips its zstd leg without it)

    HAVE_ZSTD = True
except ImportError:
    HAVE_ZSTD = False

N_MAIN = 10_000_000
N_SORTED = 1_000_000
N_CHECK = 100_003  # not a multiple of the 256-thread block
N_GZIP = 2_000_000
N_MOLECULES = 1_000_000
N_LIE = 1_000_000
N_SORT_LAB = 1 << 24  # the sort lab's default
N_READS = 10_000_000  # reads of the workflow phase
N_COHORT = 10_000_000  # records of the cohort phase
CELLS = 3_000  # planted cell barcodes of the workflow phase
GENE_INDEX = 20_000  # the index pool: the size of a human gene annotation
ERROR_RATE = 0.2  # reads whose barcode carries one substituted base
#: the workflow's batches: about 15k distinct barcodes per histogram batch of
#: the sorted raw file (the default 4M would come close to the 65,536 per
#: shard), and about 0.9M distinct (barcode, gene) pairs per count batch
WF_BATCH = 1 << 20
WF_MAX_PAIRS = 1 << 22
N_FASTQ = 5_000_000  # reads of the FASTQ phase (5M keeps the whole script under 7 minutes)
N_FASTQ_GZIP = 1_000_000  # reads of its gzip leg, and the slice held against numpy
EXPORT_BATCH = 1 << 20  # export_fastq's default batch
INGEST_BATCH = 200_000  # ingest_fastq's default batch
FASTQ_READ_BYTES = 2 + 20 + 1 + 28 + 3 + 28 + 1  # 83 per bc16/umi12 read
FILTER_BARCODES = 1_000
BARCODE_POOL = 50_000  # a single-cell run's cells plus background
GENES = 2_000  # index pool of the molecule phase (the count matrix's columns)
BC_LEN, UMI_LEN = 16, 12
#: the XOR deltas of every single-base substitution of a workflow barcode
C_DELTAS = variant_deltas(BC_LEN)
#: device bytes per bc16/umi12 record, each way: 16 + 12 + 8 in, 24 out
BYTES_PER_RECORD = 60
#: device bytes per 16-base field record: 16 B of ASCII and one 8 B word
BYTES_PER_FIELD = 24
LENGTHS = (1, 15, 16, 17, 31, 32)
SALTS = (0xA5A5A5A5, 0xFFFFFFFF)
KERNELS = {
    "encode_records": (K.encode_records, K.plain_encode_records, 252),
    "decode_records": (K.decode_records, K.plain_decode_records, 327),
    "encode_planes": (K.encode_planes, K.plain_encode_planes, 166),
    "decode_planes": (K.decode_planes, K.plain_decode_planes, 205),
}
SEED = 0
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
ANY_BYTE = bytes(range(256))  # the codec is total and the lab floors see raw bytes
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

    def encode_case(name, bc, umi, idx, salt=None):
        nonlocal count
        err = max_abs_err([K.encode_records(bc, umi, idx, salt)],
                          [K.plain_encode_records(bc, umi, idx, salt)])
        torch.cuda.synchronize()
        require(err == 0.0, f"encode {name}: max_abs_err {err}")
        count += 1

    def decode_case(name, records, bc_len, umi_len, salt=None):
        nonlocal count
        err = max_abs_err(
            K.decode_records(records, bc_len, umi_len, salt),
            K.plain_decode_records(records, bc_len, umi_len, salt),
        )
        torch.cuda.synchronize()
        require(err == 0.0, f"decode {name}: max_abs_err {err}")
        count += 1

    def planes_case(name, rows):
        nonlocal count
        length = rows.shape[1]
        words = K.encode_planes(rows)
        err = max_abs_err([words], [K.plain_encode_planes(rows)])
        back = card_words(rows.shape[0], gen, card)  # bits above 2L are ignored
        err = max(err, max_abs_err([K.decode_planes(words, length), K.decode_planes(back, length)],
                                   [K.plain_decode_planes(words, length),
                                    K.plain_decode_planes(back, length)]))
        torch.cuda.synchronize()
        require(err == 0.0, f"planes {name}: max_abs_err {err}")
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
    for salt in SALTS:
        name = f"salt {salt:#x}"
        encode_case(name, card_rows(n, BC_LEN, gen, card), card_rows(n, UMI_LEN, gen, card),
                    bit63, salt)
        decode_case(name, card_words(n, gen, card, (3,)), BC_LEN, UMI_LEN, salt)
        salted = K.encode_records(lower, lower[:, :10].contiguous(), bit63, salt)
        require(torch.equal(K.decode_records(salted, 20, 10, salt)[2], bit63),
                f"{name} round trip gives back the index")

    for L in LENGTHS:
        planes_case(f"L={L} n={n}", card_rows(n, L, gen, card))
    buf = card_rows(1, n * BC_LEN + 1, gen, card)[0]
    planes_case("misaligned row view", buf[1:].view(n, BC_LEN))
    planes_case("lowercase", lower)
    require(torch.equal(K.decode_planes(K.encode_planes(lower), 20), lower - 32),
            "lowercase planes decode to uppercase")
    planes_case("all-T32", t32)
    require(bool((K.encode_planes(t32) == -1).all()), "all-T32 planes set bit 63")
    torch.cuda.synchronize()
    return count


def wall(step: str, fn, walls: dict | None = None, key: str | None = None):
    """``fn()``, with its wall time in seconds (one run, ended by a
    synchronise) printed and, given ``walls``, kept there under ``key``."""
    t0 = time.perf_counter()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    log(f"wall: {step}: {dt:.3f} s")
    if walls is not None:
        walls[key] = dt
    return out


@contextlib.contextmanager
def forced_engine(engine: str):
    """``IBU_AUTO_ENGINE=engine`` for the calls inside, then as it was."""
    before = os.environ.get("IBU_AUTO_ENGINE")
    os.environ["IBU_AUTO_ENGINE"] = engine
    try:
        yield
    finally:
        if before is None:
            del os.environ["IBU_AUTO_ENGINE"]
        else:
            os.environ["IBU_AUTO_ENGINE"] = before


def main_path(card, n_main: int, n_sorted: int, workdir: Path) -> None:
    """Phase 4: the port's entry points, as a user calls them."""
    rng = np.random.default_rng(SEED)
    bc = ACGT[rng.integers(0, 4, (n_main, BC_LEN), dtype=np.uint8)]
    umi = ACGT[rng.integers(0, 4, (n_main, UMI_LEN), dtype=np.uint8)]
    idx = rng.integers(0, 1 << 64, size=n_main, dtype=np.uint64)
    oracle = PL.encode_batch(bc, umi, idx, engine="host")

    K.encode_records.launches = 0
    K.decode_records.launches = 0
    records = wall(f"encode_batch {n_main}", lambda: PL.encode_batch(
        bc, umi, idx, engine="device", device=card))
    require(records.tobytes() == oracle.tobytes(), "encode_batch equals the host codec")
    got = wall(f"decode_batch {n_main}", lambda: PL.decode_batch(
        records, BC_LEN, UMI_LEN, engine="device", device=card))
    for a, b, what in zip(got, (bc, umi, idx), ("barcodes", "UMIs", "indices")):
        require(np.array_equal(a, b), f"decode_batch gives back the {what}")

    sorted_path = str(workdir / "sorted.ibu")
    oracle_path = str(workdir / "oracle.ibu")
    wall(f"encode_sorted_file {n_sorted}",
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
    before = K.decode_records.launches
    with forced_engine("device"):  # decode_file takes no engine
        hdr, dbc, dumi, didx = wall(f"decode_file {n_sorted}",
                                     lambda: PL.decode_file(sorted_path, device=card))
    require(K.decode_records.launches == before + 1, "decode_file launched decode_records once")
    require(hdr.sorted() and (hdr.bc_len, hdr.umi_len) == (BC_LEN, UMI_LEN), "decode_file header")
    require(np.array_equal(dbc, C.np_unpack(want["barcode"], BC_LEN)), "decode_file barcodes")
    require(np.array_equal(dumi, C.np_unpack(want["umi"], UMI_LEN)), "decode_file UMIs")
    require(np.array_equal(didx, want["index"]), "decode_file indices")

    stats_path = str(workdir / "stats.ibu")
    with Writer.from_path(stats_path, Header.new(BC_LEN, UMI_LEN)) as w:
        w.write_batch(records)
    stats = wall(f"file_stats device {n_main}",
                  lambda: PL.file_stats(stats_path, engine="device", device=card))
    nat = native.checksum_parallel(stats_path, MmapReader(stats_path).len())
    np_sums = tuple(int(records[f].sum(dtype=np.uint64)) for f in ("barcode", "umi", "index"))
    got_sums = (stats["barcode_sum"], stats["umi_sum"], stats["index_sum"])
    log(f"record path: file_stats {stats}")
    require(stats["count"] == n_main, "file_stats count")
    require(got_sums == nat, f"file_stats sums {got_sums} equal the native engine {nat}")
    require(got_sums == np_sums, f"file_stats sums equal numpy {np_sums}")


def reset_launches() -> None:
    for kernel, _, _ in KERNELS.values():
        kernel.launches = 0


def read_launches() -> dict:
    return {name: kernel.launches for name, (kernel, _, _) in KERNELS.items()}


def matrix_phase(card) -> dict:
    """Phase 5: the validation matrix on the card, as ``python -m
    ibu_tpu_torch.validate`` runs it."""
    names = list(json.loads((ROOT / "TPU_VALIDATE.json").read_text())["checks"])
    reset_launches()
    t0 = time.perf_counter()
    results = run_matrix(progress=log, device=card)
    torch.cuda.synchronize()
    launches = read_launches()
    passed = sum(ok for _, ok in results)
    log(f"validation matrix: {passed}/{len(results)} passed ({time.perf_counter() - t0:.2f} s); "
        f"launches {launches}")
    require([name for name, _ in results] == names, "matrix checks are named as in TPU_VALIDATE.json")
    require(passed == len(names), "every matrix check passes")
    require(all(v > 0 for v in launches.values()), "every kernel ran in the matrix")
    return launches


def write_ibu(path: Path, records: np.ndarray, sorted_flag: bool = False, **kwargs) -> str:
    header = Header.new(BC_LEN, UMI_LEN)
    if sorted_flag:
        header.set_sorted()
    with Writer.from_path(str(path), header, **kwargs) as w:
        w.write_batch(records)
    return str(path)


def raises(fn, match: str) -> str:
    try:
        fn()
    except ValueError as e:
        require(match in str(e), f"error names {match!r}: {e}")
        return str(e)
    raise RuntimeError(f"check failed: expected a ValueError naming {match!r}")


def histogram_path(card, n: int, workdir: Path) -> None:
    """Phase 6: per-barcode counts of a 10M-record file through every
    histogram engine, each against the host engine and numpy."""
    rng = np.random.default_rng(SEED + 2)
    pool = rng.permutation(np.unique(rng.integers(0, 1 << 32, 2 * BARCODE_POOL, dtype=np.uint64)))
    pool = pool[:BARCODE_POOL]
    weights = 1.0 / np.arange(1, BARCODE_POOL + 1)  # Zipf, s = 1
    bc = pool[rng.choice(BARCODE_POOL, size=n, p=weights / weights.sum())]
    umi = rng.integers(0, 1 << (2 * UMI_LEN), n, dtype=np.uint64)
    records = make_records(bc, umi, np.arange(n, dtype=np.uint64))
    want_keys, want_counts = np.unique(bc, return_counts=True)
    want = dict(zip(want_keys.tolist(), want_counts.tolist()))
    log(f"histogram path: {n} records, {len(want)} distinct barcodes, "
        f"largest count {int(want_counts.max())}")

    unsorted = write_ibu(workdir / "hist.ibu", records)
    srt = wall(f"sort_batch {n}", lambda: PL.sort_batch(
        records, bc_len=BC_LEN, umi_len=UMI_LEN, index_bits=32, device=card))
    require(np.array_equal(srt["barcode"], np.sort(bc)), "sort_batch orders the barcodes")
    sorted_path = write_ibu(workdir / "hist_sorted.ibu", srt, sorted_flag=True)

    host = wall(f"barcode_counts host {n}", lambda: PL.barcode_counts(unsorted, engine="host"))
    require(np.array_equal(host[0], want_keys) and np.array_equal(host[1], want_counts),
            "the host engine equals numpy")
    for label, path in (("unsorted", unsorted), ("sorted", sorted_path)):
        got = wall(f"stream_file_histogram {label} {n}",
                    lambda: D.stream_file_histogram(MmapReader(path), device=card))
        require(got == want, f"stream_file_histogram {label} equals numpy")
        keys, counts = wall(f"barcode_counts device {label} {n}",
                             lambda: PL.barcode_counts(path, engine="device", device=card))
        require(np.array_equal(keys, host[0]) and np.array_equal(counts, host[1]),
                f"barcode_counts device {label} equals the host engine")

    spill = D.DeviceHistogram(capacity=16384, spill=True, device=card)
    got = wall(f"DeviceHistogram capacity=16384 spill {n}",
                lambda: spill.run(D.record_batches_from_mmap(MmapReader(unsorted))))
    require(got == want and len(spill._spilled) > 0, "the spill path is exact and engaged")
    strict = D.DeviceHistogram(capacity=16384, spill=False, device=card)
    log("histogram path: strict capacity: " + raises(
        lambda: strict.run(D.record_batches_from_mmap(MmapReader(unsorted))), "device table"))
    lie = write_ibu(workdir / "lie.ibu", records[:N_LIE], sorted_flag=True)
    log("histogram path: lying sorted flag: " + raises(
        lambda: D.stream_file_histogram(MmapReader(lie), device=card), "sorted"))

    head = records[:N_GZIP]
    gz = write_ibu(workdir / "hist.ibu.gz", head, compression="gzip", level=1)
    gz_want = PL.host_stream_histogram(Reader.from_path(gz).batches())
    require(gz_want == S.barcode_histogram_np(head), "the gzip host engine equals numpy")
    got = wall(f"DeviceHistogram gzip {len(head)}",
                lambda: D.DeviceHistogram(device=card).run(Reader.from_path(gz).batches()))
    require(got == gz_want, "DeviceHistogram over a gzip stream equals the host engine")
    got = wall(f"sharded_barcode_histogram gzip {len(head)}",
                lambda: D.sharded_barcode_histogram(Reader.from_path(gz).batches(), device=card))
    require(got == gz_want, "sharded_barcode_histogram over a gzip stream equals the host engine")

    m = min(N_MOLECULES, n)
    mrec = make_records(bc[:m], umi[:m], rng.integers(0, GENES, m, dtype=np.uint64))
    dev = records_to_tensor(mrec, card)
    keys, mol, n_uniq = wall(f"molecule_counts {m}", lambda: S.molecule_counts(
        dev, 1 << 16, bc_len=BC_LEN, umi_len=UMI_LEN))
    mol_want = S.molecule_counts_np(mrec)
    require(S.table_dict(keys, mol) == mol_want and int(n_uniq) == len(mol_want),
            "molecule_counts equals numpy")
    keys, counts, n_pairs = wall(f"pair_molecule_counts {m}", lambda: S.pair_molecule_counts(
        dev, 1 << 20, bc_len=BC_LEN, umi_len=UMI_LEN, index_bits=32))
    pair_want = S.pair_molecule_counts_np(mrec)
    require(S.table_dict(keys, counts) == pair_want and int(n_pairs) == len(pair_want),
            "pair_molecule_counts equals numpy")
    log(f"histogram path: {len(mol_want)} barcodes with molecules, {len(pair_want)} "
        "(barcode, gene) pairs")


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


def device_ms(fn, sets, iters: int = 20, warm: bool = True) -> float | None:
    """Mean device time per call of the kernels (and copies) ``fn`` launches,
    summed over ``torch.profiler``'s record of each in ``iters`` back-to-back
    calls: their own time, with no host time or idle gaps in it. ``None``
    when the profiler recorded none. ``warm`` runs one call first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn(*sets[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*sets[i % len(sets)])
        torch.cuda.synchronize()
    kernels = [e.time_range for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return None
    return sum(r.elapsed_us() for r in kernels) / iters / 1e3


def as_tuple(out):
    return list(out) if isinstance(out, tuple) else [out]


def time_kernels(card, n: int, launches: dict) -> list[dict]:
    """Phase 7: kernel and plain version at the main path's shapes."""
    gen = torch.Generator(device=card).manual_seed(SEED + 1)
    enc_sets = [
        (card_rows(n, BC_LEN, gen, card), card_rows(n, UMI_LEN, gen, card), card_words(n, gen, card))
        for _ in range(3)
    ]
    plane_sets = [(card_rows(n, BC_LEN, gen, card),) for _ in range(3)]
    sets = {
        "encode_records": (enc_sets, BYTES_PER_RECORD),
        "decode_records": ([(K.encode_records(*s), BC_LEN, UMI_LEN) for s in enc_sets],
                           BYTES_PER_RECORD),
        "encode_planes": (plane_sets, BYTES_PER_FIELD),
        "decode_planes": ([(K.encode_planes(*s), BC_LEN) for s in plane_sets], BYTES_PER_FIELD),
    }
    out = []
    for name, (kernel, plain, line) in KERNELS.items():
        inputs, nbytes = sets[name]
        got = as_tuple(kernel(*inputs[0]))
        err = max_abs_err(got, as_tuple(plain(*inputs[0])))
        torch.cuda.synchronize()
        require(err == 0.0, f"{name} agrees with its plain version at n={n}")
        ms, plain_ms = time_pair(kernel, plain, inputs, iters=20, plain_iters=5)
        gbps = nbytes * n / (ms * 1e6)
        plain_gbps = nbytes * n / (plain_ms * 1e6)
        bound = bound_ms(inputs[0], got)
        log(f"timing: {name} n={n}: kernel {ms:.4f} ms ({gbps:.1f} GB/s at "
            f"{nbytes} B/record), plain {plain_ms:.4f} ms ({plain_gbps:.1f} GB/s), "
            f"bound {bound:.4f} ms")
        out.append({
            "name": name,
            "route": "cuda",
            "source": "ibu_tpu_torch/csrc/codec.cu",
            "replaces": f"ibu_tpu/ops/codec_pallas.py:{line}",
            "launches": launches[name],
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "bytes",
            "library_ms": None,  # no one PyTorch call packs or unpacks 2-bit bases
            "gbps": gbps,
            "plain_gbps": plain_gbps,
        })
    return out


def lab_cases(card, n: int) -> list[tuple[str, str, dict, list]]:
    """``(wrapper, mode label, keyword arguments, 3 input sets)`` for every
    mode of every lab kernel at the labs' shapes; each wrapper's default mode
    comes first."""
    gen = torch.Generator(device=card).manual_seed(SEED + 3)
    enc = [(card_rows(n, BC_LEN, gen, card, ANY_BYTE), card_rows(n, UMI_LEN, gen, card, ANY_BYTE),
            card_words(n, gen, card)) for _ in range(3)]
    recs = {cols: [(card_words(n, gen, card, (cols,)),) for _ in range(3)] for cols in (3, 4)}
    rows = {"sep": [((bc, umi), idx) for bc, umi, idx in enc],
            "comb": [((card_rows(n, 32, gen, card, ANY_BYTE),), idx) for _, _, idx in enc]}
    packed = [(bc.view(torch.int32), umi.view(torch.int32), idx) for bc, umi, idx in enc]
    cases = [("sol_encode", mode, {"mode": mode}, enc) for mode in LK.ENC_MODES]
    cases += [("sol_decode", mode, {"mode": mode}, recs[3]) for mode in LK.DEC_MODES]
    for sol in (False, True):
        label = "touch" if sol else "real"
        cases += [("packed_encode", label, {"sol": sol}, packed),
                  ("packed_decode", label, {"sol": sol}, recs[3])]
    cases += [("layout_encode", f"{enc_in}{cols}", {"records": cols}, rows[enc_in])
              for enc_in in ("sep", "comb") for cols in (3, 4)]
    cases += [("layout_decode", f"{cols}{'comb' if comb else 'sep'}", {"comb": comb}, recs[cols])
              for comb in (False, True) for cols in (3, 4)]
    return cases


def tensor_bytes(*parts) -> int:
    """Bytes of every tensor in ``parts``, nested tuples included."""
    total = 0
    for part in parts:
        if isinstance(part, torch.Tensor):
            total += part.numel() * part.element_size()
        elif isinstance(part, (tuple, list)):
            total += tensor_bytes(*part)
    return total


def bound_ms(inputs, outputs) -> float:
    """The least time the card could take: every input tensor read once and
    every output written once at the H100's published 3350 GB/s
    (:data:`ibu_tpu_torch.labs._harness.PEAK_GBPS`). The kernels here do a
    few integer operations per byte, so bytes, not operations, bound them."""
    return tensor_bytes(inputs, outputs) / (LH.PEAK_GBPS * 1e6)


def labs_phase(card, n: int) -> list[dict]:
    """Phase 8: both codec labs at the main path's size, then every lab
    kernel against its plain version."""
    for kernel, _, _ in LK.KERNELS.values():
        kernel.launches = 0
    t0 = time.perf_counter()
    sol_rows, halves, sol_failed = sol_lab.run(card, n, list(sol_lab.VARIANTS), log=log)
    layout_rows, layout_failed = kernel_lab.run(card, n, log=log)
    torch.cuda.synchronize()
    launches = {name: kernel.launches for name, (kernel, _, _) in LK.KERNELS.items()}
    log(f"labs: {len(sol_rows) - 1} sol_lab variants and {len(layout_rows) - 2} kernel_lab rows "
        f"checked and timed ({time.perf_counter() - t0:.2f} s); launches {launches}")
    require(not sol_failed and not layout_failed,
            f"every lab variant matches the host oracle (failed: {sol_failed + layout_failed})")
    require(all(v > 0 for v in launches.values()), "every lab kernel ran in the labs")
    for line in sol_lab.report(sol_rows, halves):
        log(f"sol_lab: {line}")
    for line in LH.table(layout_rows, layout_rows[0].ms) + [LH.floor_line(layout_rows[0])]:
        log(f"kernel_lab: {line}")

    entries = {name: {} for name in LK.KERNELS}
    for name, label, kwargs, sets in lab_cases(card, n):
        kernel, plain, _ = LK.KERNELS[name]
        kernel, plain = functools.partial(kernel, **kwargs), functools.partial(plain, **kwargs)
        got = as_tuple(kernel(*sets[0]))
        err = max_abs_err(got, as_tuple(plain(*sets[0])))
        torch.cuda.synchronize()
        require(err == 0.0, f"{name} {label} agrees with its plain version at n={n}")
        ms, plain_ms = time_pair(kernel, plain, sets, iters=20, plain_iters=5)
        moved = tensor_bytes(sets[0], got) / n
        entries[name][label] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                "bound_ms": bound_ms(sets[0], got),
                                "bytes_per_record": moved, "gbps": moved * n / (ms * 1e6),
                                "plain_gbps": moved * n / (plain_ms * 1e6)}
        log(f"timing: {name} {label} n={n}: kernel {ms:.4f} ms ({moved * n / (ms * 1e6):.1f} GB/s "
            f"at {moved:g} B/record), plain {plain_ms:.4f} ms, exact")
    out = []
    for name, modes in entries.items():
        label, first = next(iter(modes.items()))
        out.append({
            "name": name,
            "route": "cuda",
            "source": "ibu_tpu_torch/csrc/codec_lab.cu",
            "replaces": LK.KERNELS[name][2],
            "launches": launches[name],
            "max_abs_err": max(m["max_abs_err"] for m in modes.values()),
            "ms": first["ms"],
            "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,  # no one PyTorch call computes a codec mode
            "gbps": first["gbps"],
            "plain_gbps": first["plain_gbps"],
            "mode": label,
            "modes": modes,
        })
    return out


def sort_lab_phase(card, n: int) -> list[dict]:
    """Phase 9: the radix-sort lab at ``n`` keys as ``python -m
    ibu_tpu_torch.labs.sort_lab`` runs it, then each of its kernels against
    its plain version."""
    for kernel, _, _ in SK.KERNELS.values():
        kernel.launches = 0
    t0 = time.perf_counter()
    rows, failed = sort_lab.run(card, n, log=lambda line: log(f"sort_lab: {line}"))
    torch.cuda.synchronize()
    launches = {name: kernel.launches for name, (kernel, _, _) in SK.KERNELS.items()}
    log(f"sort_lab: checked and timed at {n} keys ({time.perf_counter() - t0:.2f} s); "
        f"launches {launches}")
    require(not failed, f"every sort lab kernel matches the numpy oracles (failed: {failed})")
    require(all(v > 0 for v in launches.values()), "every sort lab kernel ran in the lab")
    for line in sort_lab.report(rows):
        log(f"sort_lab: {line}")
    lab = {row["name"]: row for row in rows}

    def offsets(m: int) -> torch.Tensor:
        return torch.from_numpy(sort_lab.make_offsets(m // SK.TILE)).to(card)

    def args(name: str, keys: torch.Tensor, offs: torch.Tensor) -> tuple:
        return (keys, offs) if name == "dynamic_store" else (keys,)

    offs = offsets(n)
    keys = sort_lab.make_keys(n, 1, card)
    cases = [("lab keys", keys, offs),
             ("one low byte", (keys & -256) | 0x5A, offs),
             ("16384 keys", sort_lab.make_keys(SK.KEYS_MULTIPLE, 2, card), offsets(SK.KEYS_MULTIPLE))]
    # the cases that break the redesigned rank and store kernels, at the lab's
    # size and at 8 and 24 tiles (the store takes 4 tiles per block)
    sizes = (n, 8 * SK.TILE, 24 * SK.TILE)
    rank_cases = [(f"{case} n={m}", sort_lab.case_keys(m, case, card), None)
                  for m in sizes for case in sort_lab.RANK_CASES]
    store_cases = [(f"offsets {case} n={m}", sort_lab.make_keys(m, 3, card),
                    torch.from_numpy(sort_lab.case_offsets(m // SK.TILE, case)).to(card))
                   for m in sizes for case in sort_lab.STORE_CASES]
    extra = {"digit_histogram": rank_cases, "rank_cumsum": rank_cases, "dynamic_store": store_cases}
    timed_sets = [sort_lab.make_keys(n, seed, card) for seed in sort_lab.TIMED_SEEDS]
    out = []
    for (name, (kernel, plain, line)), row in zip(SK.KERNELS.items(), sort_lab.KERNEL_ROWS):
        err = 0.0
        for label, case_keys, case_offs in cases + extra[name]:
            case = args(name, case_keys, case_offs)
            err = max(err, max_abs_err(as_tuple(kernel(*case)), as_tuple(plain(*case))))
            torch.cuda.synchronize()
            require(err == 0.0, f"{name} agrees with its plain version on {label}")
        sets = [args(name, k, offs) for k in timed_sets]
        ms, plain_ms = time_pair(kernel, plain, sets, iters=20, plain_iters=5)
        bound = lab[row]["bound_ms"]
        profiled = device_ms(kernel, sets)
        entry = {
            "name": name,
            "route": "cuda",
            "source": "ibu_tpu_torch/csrc/sort_lab.cu",
            "replaces": line,
            "launches": launches[name],
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "bytes",
            "library_ms": None,  # no one PyTorch call gives per-tile ranks or ordered stores
            "lab_ms": lab[row]["ms"],
            "device_ms": profiled,
        }
        lib_note = ""
        if name == "digit_histogram":
            tiles = n // SK.TILE

            def bincount(index, tiles=tiles):
                return torch.bincount(index, minlength=tiles * SK.DIGITS)

            def index_bincount(k):
                return bincount(SK._tile_digits(k))

            want = index_bincount(sets[0][0]).view(tiles, SK.DIGITS).to(torch.int32)
            require(torch.equal(kernel(*sets[0]), want), "torch.bincount gives the histogram")
            # no one call maps keys to per-tile counts: library_ms times the
            # index pass and torch.bincount together, bincount_ms the call alone
            # on an index made beforehand
            entry["library_ms"], _ = time_pair(index_bincount, index_bincount,
                                               [s[0:1] for s in sets], 20, 1)
            entry["bincount_ms"], _ = time_pair(bincount, bincount,
                                                [(SK._tile_digits(s[0]),) for s in sets], 20, 1)
            # the lab's yardsticks: whole sorts, not calls computing the histogram
            entry["yardstick_ms"] = {sort_lab.SORT1: lab[sort_lab.SORT1]["ms"],
                                     sort_lab.SORT3: lab[sort_lab.SORT3]["ms"]}
            lib_note = (f", index + torch.bincount {entry['library_ms']:.4f} ms "
                        f"(torch.bincount alone {entry['bincount_ms']:.4f} ms)")
        prof_note = "not measured" if profiled is None else f"{profiled:.4f} ms"
        log(f"timing: {name} n={n}: kernel {ms:.4f} ms (profiler: {prof_note}), plain "
            f"{plain_ms:.4f} ms, bound {bound:.4f} ms{lib_note}, exact on "
            f"{len(cases) + len(extra[name])} cases")
        out.append(entry)
    return out


def dedup_oracle(in_path: str, out_path: str) -> None:
    """A numpy statement of ``dedup_file``'s rewrite: the records in (barcode,
    umi, index) order, the first of each (barcode, umi) pair kept, under the
    input's header with the sorted flag set."""
    reader = MmapReader(in_path)
    recs = np.asarray(reader.records)
    recs = recs[np.lexsort((recs["index"], recs["umi"], recs["barcode"]))]
    keep = np.ones(len(recs), dtype=bool)
    keep[1:] = (recs["barcode"][1:] != recs["barcode"][:-1]) | (recs["umi"][1:] != recs["umi"][:-1])
    header = reader.header()
    header.set_sorted()
    with Writer.from_path(out_path, header) as w:
        w.write_batch(recs[keep])


def neighbour_in_truth(pair: tuple[int, int], planted: set, truth: dict) -> bool:
    """Whether ``(barcode, gene)`` is explained by a barcode collision: the
    barcode is a planted cell one substitution away from another planted
    cell that holds the gene. A read of that other cell whose error is that
    substitution carries this cell's barcode exactly, so no corrector can
    tell them apart."""
    barcode, gene = pair
    return barcode in planted and any(
        (barcode ^ d, gene) in truth and barcode ^ d in planted
        for d in C_DELTAS.tolist())


def host_profile(fn, top: int = 8) -> list[str]:
    """The functions with the most own host time in one call of ``fn``
    (``cProfile``; a wait on the card shows in the call that waits)."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    fn()
    prof.disable()
    dt = time.perf_counter() - t0
    rows = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: kv[1][2], reverse=True)
    return [f"wall {dt:.3f} s under cProfile"] + [
        f"{own:.3f} s own, {calls} calls: {name} ({Path(path).name}:{line})"
        for (path, line, name), (_, calls, own, _, _) in rows[:top]]


def count_trio(prefix: str) -> tuple[bytes, ...]:
    return tuple(Path(f"{prefix}{ext}").read_bytes()
                 for ext in (".mtx", ".barcodes.txt", ".indices.txt"))


def workflow_phase(card, reads: int, workdir: Path) -> dict:
    """Phase 10: the single-cell workflow after ingest, through the entry
    points a user calls, on the card. Returns the paths of its files, which
    phase 12 reads."""
    rng = np.random.default_rng(SEED)
    allow, bc_rows, umi_rows, gene, truth = wall(
        f"workflow generate {reads} reads",
        lambda: WF.make_ground_truth(rng, CELLS, GENE_INDEX, reads, ERROR_RATE))
    log(f"workflow: {reads} reads, {CELLS} cells, {GENE_INDEX} genes, {len(truth)} true "
        "matrix entries")
    raw, allowfile = str(workdir / "wf_raw.ibu"), str(workdir / "wf_cells.txt")
    fixed, fixed_cpu = str(workdir / "wf_corrected.ibu"), str(workdir / "wf_corrected_cpu.ibu")
    mol, mol_oracle = str(workdir / "wf_molecules.ibu"), str(workdir / "wf_molecules_np.ibu")
    by_card, by_host = str(workdir / "wf_sorted_card.ibu"), str(workdir / "wf_sorted_native.ibu")

    reset_launches()
    wall(f"workflow ingest encode_sorted_file {reads}", lambda: PL.encode_sorted_file(
        raw, bc_rows, umi_rows, index=gene, device=card))
    kstats = wall(f"workflow cells call_cells device {reads}", lambda: PL.call_cells(
        raw, allowfile, method="ordmag", expect=CELLS, engine="device",
        batch_records=WF_BATCH, device=card))
    with open(allowfile) as f:
        called = np.sort(C.encode_seqs([line.strip() for line in f if line.strip()]))
    log(f"workflow: cells {kstats}")
    require(np.array_equal(called, allow), "the called allowlist equals the planted one")

    cstats = wall(f"workflow correct_file card {reads}",
                   lambda: PL.correct_file(raw, fixed, called, device=card))
    cpu_stats = wall(f"workflow correct_file cpu {reads}",
                      lambda: PL.correct_file(raw, fixed_cpu, called, device="cpu"))
    log(f"workflow: correct {cstats}")
    require(cstats == cpu_stats and Path(fixed).read_bytes() == Path(fixed_cpu).read_bytes(),
            "correct_file on the card equals the CPU run (file and statistics)")

    wall(f"workflow sort_file_device {reads}", lambda: PL.sort_file_device(fixed, by_card, device=card))
    wall(f"workflow native.sort_file {reads}", lambda: native.sort_file(fixed, by_host))
    require(filecmp.cmp(by_card, by_host, shallow=False),
            "sort_file_device is byte-identical to native.sort_file")
    os.unlink(by_card)
    os.unlink(by_host)
    dstats = wall(f"workflow dedup_file native sort {reads}",
                   lambda: PL.dedup_file(fixed, mol, assume_sorted=False, device=card))
    wall("workflow dedup numpy statement", lambda: dedup_oracle(fixed, mol_oracle))
    log(f"workflow: dedup {dstats}")
    require(Path(mol).read_bytes() == Path(mol_oracle).read_bytes(),
            "dedup_file is byte-identical to the numpy statement")

    molecules = dstats["molecules"]
    dev = wall(f"workflow count_matrix device {molecules}", lambda: PL.count_matrix(
        mol, str(workdir / "wf_dev"), batch_records=WF_BATCH, engine="device",
        max_pairs=WF_MAX_PAIRS, device=card))
    walls: dict = {}
    host = wall(f"workflow count_matrix host {molecules}", lambda: PL.count_matrix(
        mol, str(workdir / "wf_host"), batch_records=WF_BATCH), walls, "count")
    log(f"workflow: count {dev}")
    require(dev == host and count_trio(str(workdir / "wf_dev")) == count_trio(
        str(workdir / "wf_host")), "count_matrix device is byte-identical to host")
    entries, missing = wall("workflow truth check", lambda: WF.entries_outside_truth(mol, truth))
    planted = set(allow.tolist())
    unexplained = [p for p in missing if not neighbour_in_truth(p, planted, truth)]
    log(f"workflow: {len(missing)} of {entries} entries lie outside the planted truth, "
        f"{len(missing) - len(unexplained)} of them explained by a barcode collision (a planted "
        "cell one substitution from another planted cell that holds the gene)")
    require(entries == dev["entries"] and not unexplained,
            f"every matrix entry lies in the planted truth or is a barcode collision "
            f"({unexplained[:5]} are neither)")
    launches = read_launches()
    log(f"launches on the workflow path: {launches}")
    require(launches["encode_records"] > 0, "encode_records ran on the workflow path")

    # count_matrix(engine="device") is not run again here to keep the script
    # under 7 minutes: PERF.md holds its device time and host profile
    again = {
        "correct_file": lambda: PL.correct_file(raw, str(workdir / "wf_again.ibu"), called,
                                                device=card),
        "dedup_file": lambda: PL.dedup_file(fixed, str(workdir / "wf_again.ibu"),
                                            assume_sorted=False, device=card),
    }
    for name in ("correct_file",):
        t0 = time.perf_counter()
        ms = device_ms(again[name], [()], iters=1, warm=False)
        dt = time.perf_counter() - t0
        note = "not measured" if ms is None else f"{ms:.3f} ms ({ms / (dt * 1e3):.1%} of the wall)"
        log(f"workflow profile: {name}: device {note}; wall under the profiler {dt:.3f} s")
    for name, fn in again.items():
        for line in host_profile(fn):
            log(f"workflow host profile: {name}: {line}")
    log(f"workflow: {entries - len(missing)} of {entries} entries in the planted truth "
        f"({(entries - len(missing)) / len(truth):.1%} coverage)")
    return {"raw": raw, "cells": allowfile, "corrected": fixed, "molecules": mol,
            "counts": str(workdir / "wf_host"), "count_wall": walls["count"]}


def pinned_memory(reset: bool = False) -> str:
    """Pinned host memory the caching allocator holds now and at its peak,
    where this torch reports it; ``reset`` starts a new peak."""
    stats = getattr(torch.cuda, "host_memory_stats", None)
    if stats is None or not torch.cuda.is_available():
        return "not reported by this torch"
    if reset and hasattr(torch.cuda, "reset_peak_host_memory_stats"):
        torch.cuda.reset_peak_host_memory_stats()
    s = stats()
    return ", ".join(f"{key} {s[key] / 2**20:.0f} MiB"
                     for key in ("allocated_bytes.current", "allocated_bytes.peak") if key in s)


def fastq_statement(path: str, records: np.ndarray, start: int = 0) -> None:
    """Hold the ``len(records)`` reads from read ``start`` of the FASTQ at
    ``path`` against a numpy statement of the format: ``@r`` and the index as
    20 decimal digits, the barcode then the UMI, ``+``, and one ``I`` per
    base."""
    m = len(records)
    with open(path, "rb") as f:
        f.seek(FASTQ_READ_BYTES * start)
        got = np.frombuffer(f.read(FASTQ_READ_BYTES * m), dtype=np.uint8)
    got = got.reshape(m, FASTQ_READ_BYTES)
    require(bool((got[:, 0] == ord("@")).all() and (got[:, 1] == ord("r")).all()),
            "every read name starts with @r")
    digits = got[:, 2:22].astype(np.uint64) - np.uint64(ord("0"))
    require(bool((digits <= 9).all()), "read names are decimal digits")
    names = (digits * (np.uint64(10) ** np.arange(19, -1, -1, dtype=np.uint64))).sum(axis=1)
    require(np.array_equal(names, records["index"]),
            "read names are the record indices")
    for col in (22, 51, 53, 82):
        require(bool((got[:, col] == ord("\n")).all()), f"column {col} is a newline")
    require(np.array_equal(got[:, 23:39], C.np_unpack(records["barcode"], BC_LEN)),
            "the sequence starts with the barcode")
    require(np.array_equal(got[:, 39:51], C.np_unpack(records["umi"], UMI_LEN)),
            "the UMI follows the barcode")
    require(bool((got[:, 52] == ord("+")).all()), "the third line is +")
    require(bool((got[:, 54:82] == ord("I")).all()), "the quality is I for every base")


def check_fastq_shapes(card, records: np.ndarray) -> None:
    """Both record kernels against their plain versions, exactly, on the
    file's own records at each batch shape the FASTQ path and the CLI's
    ``decode`` give them: the export's and the ``Reader``'s full and tail
    batches (decode) and the ingest's (encode, on the rows those records
    decode to)."""
    n = len(records)
    shapes = {}
    for name, batch in (("export", EXPORT_BATCH), ("ingest", INGEST_BATCH),
                        ("decode Reader", DEFAULT_BUFFER_RECORDS)):
        shapes[f"{name} batch"] = records[:batch]
        if n % batch:
            shapes[f"{name} tail"] = records[n - n % batch:]
    hold_record_kernels(card, shapes, "fastq")


def hold_record_kernels(card, shapes: dict, phase: str) -> None:
    """Decode each ``label → records`` part with ``decode_records`` and
    encode the rows back with ``encode_records``, each held exactly against
    its plain version, and the round trip against the records."""
    for label, part in shapes.items():
        words = records_to_tensor(part, card)
        rows = K.decode_records(words, BC_LEN, UMI_LEN)
        err = max_abs_err(rows, K.plain_decode_records(words, BC_LEN, UMI_LEN))
        require(err == 0.0, f"decode_records at the {label}'s {len(part)} rows: max_abs_err {err}")
        packed = K.encode_records(*rows)
        err = max_abs_err([packed], [K.plain_encode_records(*rows)])
        require(err == 0.0, f"encode_records at the {label}'s {len(part)} rows: max_abs_err {err}")
        require(torch.equal(packed, words), f"the {label} encodes back to its records")
        torch.cuda.synchronize()
        log(f"{phase}: kernels equal their plain versions at the {label}'s {len(part)} rows "
            "(max_abs_err 0)")


def leftovers(workdir: Path) -> list[str]:
    return sorted(p.name for p in workdir.iterdir() if ".run" in p.name or ".sorted" in p.name)


def fastq_phase(card, n: int, n_small: int, workdir: Path) -> tuple[dict, dict]:
    """Phase 11: FASTQ export and ingest through the entry points a user
    calls, on the card and on the host engine, engine auto-selection, and the
    file tools. Returns the codec kernels' launches in the device legs, and
    the paths of its files and the file tools' results, which phase 12
    reads."""
    rng = np.random.default_rng(SEED + 11)
    bc = ACGT[rng.integers(0, 4, (n, BC_LEN), dtype=np.uint8)]
    umi = ACGT[rng.integers(0, 4, (n, UMI_LEN), dtype=np.uint8)]
    src, fq, back = (str(workdir / name) for name in ("src.ibu", "a.fastq", "back.ibu"))
    wall(f"fastq encode_sorted_file {n}", lambda: PL.encode_sorted_file(src, bc, umi, device=card))
    del bc, umi
    records = np.asarray(MmapReader(src).records)
    export_batches, ingest_batches = -(-n // EXPORT_BATCH), -(-n // INGEST_BATCH)
    walls = {}
    check_fastq_shapes(card, records)

    # the device legs, with the launches counted
    os.environ["IBU_AUTO_ENGINE"] = "device"
    reset_launches()
    got = wall(f"fastq export_fastq device {n}", lambda: PL.export_fastq(src, fq, device=card),
               walls, "export device")
    launches = read_launches()
    require(got == n, "export_fastq returns the read count")
    require(launches["decode_records"] == export_batches and launches["encode_records"] == 0,
            f"decode_records launched once per batch ({export_batches}): {launches}")
    require(os.path.getsize(fq) == FASTQ_READ_BYTES * n, "the FASTQ holds 83 bytes per read")
    fastq_statement(fq, records[:n_small])
    fastq_statement(fq, records[n - n_small:], start=n - n_small)
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    log(f"fastq: pinned host memory before the ingest (peak reset): {pinned_memory(reset=True)}")
    reset_launches()
    got = wall(f"fastq ingest_fastq device {n}",
               lambda: PL.ingest_fastq(fq, back, BC_LEN, UMI_LEN, device=card), walls, "ingest device")
    ingest_launches = read_launches()
    launches["encode_records"] = ingest_launches["encode_records"]
    flow = ("out of core: native sort of 32 MB chunks, spilled runs, one merge"
            if native.available() else "in memory: device sort")
    log(f"fastq: ingest flow: {flow}; launches {ingest_launches}; pinned host memory after "
        f"it: {pinned_memory()}; peak RSS {rss0 / 2**20:.2f} GiB before the ingest, "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB after")
    require(native.available(), f"the host library built: {native.load_error()}")
    require(got == n, "ingest_fastq returns the read count")
    require(ingest_launches["encode_records"] == ingest_batches
            and ingest_launches["decode_records"] == 0,
            f"encode_records launched once per batch ({ingest_batches}): {ingest_launches}")
    # export writes reads in sorted order, so ingest's read numbers are the ranks
    want = records.copy()
    want["index"] = np.arange(n, dtype=np.uint64)
    header = Header.new(BC_LEN, UMI_LEN)
    header.set_sorted()
    require(Path(back).read_bytes() == header.as_bytes() + want.tobytes(),
            "ingest(export(f)) is f with arange as its index column, byte for byte")
    del want
    require(not leftovers(workdir), f"no run file is left: {leftovers(workdir)}")

    # the host legs: the same bytes
    os.environ["IBU_AUTO_ENGINE"] = "host"
    fq_host, back_host = str(workdir / "a_host.fastq"), str(workdir / "back_host.ibu")
    reset_launches()
    wall(f"fastq export_fastq host {n}", lambda: PL.export_fastq(src, fq_host, device=card),
         walls, "export host")
    require(filecmp.cmp(fq, fq_host, shallow=False), "the host engine exports the same FASTQ")
    os.unlink(fq_host)
    wall(f"fastq ingest_fastq host {n}",
         lambda: PL.ingest_fastq(fq, back_host, BC_LEN, UMI_LEN, device=card), walls, "ingest host")
    require(filecmp.cmp(back, back_host, shallow=False), "the host engine ingests the same file")
    require(all(v == 0 for v in read_launches().values()), "the host engine launches no kernel")
    os.unlink(back_host)
    os.unlink(back)
    log("fastq: walls (one run each): " + ", ".join(
        f"{leg} {dt:.3f} s ({n / dt / 1e6:.2f} M reads/s)" for leg, dt in walls.items()))

    # what "auto" decides on this card
    del os.environ["IBU_AUTO_ENGINE"]
    SEL.reset_probe_memo()
    codec = SEL.auto_codec_engine(device=card)
    stats_engine = SEL.auto_stats_engine(src, n, device=card)
    binary = SEL.auto_device_or_host(device=card)
    log(f"fastq: auto: codec -> {codec}, stats -> {stats_engine}, histogram -> {binary}; probed "
        + ", ".join(f"{k} {v:.4g}" for k, v in SEL._MEMO.items() if isinstance(v, float)))
    require(codec in ("device", "host") and binary in ("device", "host")
            and stats_engine in ("device", "native", "host"), "auto names an engine")

    # the compressed legs, with the default engine: gzip in and gzip out, and
    # zstd out where the zstandard module is installed
    small = str(workdir / "small.ibu")
    write_ibu(Path(small), records[:n_small], sorted_flag=True)
    fq_gz = str(workdir / "small.fastq.gz")
    wall(f"fastq export_fastq gzip {n_small}", lambda: PL.export_fastq(small, fq_gz, device=card))
    want = records[:n_small].copy()
    want["index"] = np.arange(n_small, dtype=np.uint64)
    for codec_name, suffix in (("gzip", ".gz"), ("zstd", ".zst")):
        if codec_name == "zstd" and not HAVE_ZSTD:
            log("fastq: zstd leg SKIPPED (no zstandard module): ingest_fastq's compression "
                "into place ran for gzip only")
            continue
        packed = str(workdir / f"small.ibu{suffix}")
        got = wall(f"fastq ingest_fastq gzip to {codec_name} {n_small}",
                    lambda: PL.ingest_fastq(fq_gz, packed, BC_LEN, UMI_LEN, device=card))
        reader = Reader.from_path(packed)
        round_trip = np.concatenate(list(reader.batches()))
        require(got == n_small and reader.header().sorted()
                and np.array_equal(round_trip, want),
                f"the gzip to {codec_name} leg gives back the records")
        require(not leftovers(workdir), f"no run file is left: {leftovers(workdir)}")
        os.unlink(packed)
        del round_trip
    os.unlink(small)
    os.unlink(fq_gz)
    del want

    tools = file_tools(src, records, n_small, workdir)

    # device time of one more run of each leg
    os.environ["IBU_AUTO_ENGINE"] = "device"
    again = {"export_fastq": lambda: PL.export_fastq(src, fq, device=card),
             "ingest_fastq": lambda: PL.ingest_fastq(fq, back, BC_LEN, UMI_LEN, device=card)}
    for name, fn in again.items():
        t0 = time.perf_counter()
        ms = device_ms(fn, [()], iters=1, warm=False)
        dt = time.perf_counter() - t0
        note = "not measured" if ms is None else f"{ms:.3f} ms ({ms / (dt * 1e3):.2%} of the wall)"
        log(f"fastq profile: {name}: device {note}; wall under the profiler {dt:.3f} s")
    for name, fn in again.items():
        for line in host_profile(fn):
            log(f"fastq host profile: {name}: {line}")
    return launches, {"src": src, "fastq": fq, "back": back, **tools}


def file_tools(src: str, records: np.ndarray, n_small: int, workdir: Path) -> dict:
    """The host file tools on phase 11's sorted file. Their outputs stay
    for phase 12; returns their paths and results."""
    n = len(records)
    rng = np.random.default_rng(SEED + 12)
    report = wall("tools check_file", lambda: PL.check_file(src))
    require(report["ok"] and report["records"] == n and report["first_order_violation"] is None
            and not report["errors"] and not report["warnings"], f"check_file passes: {report}")

    allow = records["barcode"][rng.choice(n, FILTER_BARCODES, replace=False)]
    kept = str(workdir / "kept.ibu")
    stats = wall(f"tools filter_file {FILTER_BARCODES} barcodes",
                  lambda: PL.filter_file(src, kept, allow))
    mask = np.isin(records["barcode"], allow)
    got = np.asarray(MmapReader(kept).records)
    require(stats == {"records": n, "kept": int(mask.sum()), "allowlist": len(np.unique(allow))}
            and np.array_equal(got, records[mask]) and MmapReader(kept).header().sorted(),
            f"filter_file equals the numpy mask: {stats}")
    found = wall("tools lookup_barcodes", lambda: PL.lookup_barcodes(src, allow))
    require(np.array_equal(found, got), "lookup_barcodes gives the filter's records")
    few = wall("tools lookup_barcodes 8 queries", lambda: PL.lookup_barcodes(src, allow[:8]))
    require(np.array_equal(few, records[np.isin(records["barcode"], allow[:8])]),
            "lookup_barcodes by bisection equals the numpy mask")

    shards = wall("tools split_file 4", lambda: PL.split_file(src, str(workdir / "shard{}.ibu"), 4))
    cat = str(workdir / "cat.ibu")
    stats = wall("tools concat_files", lambda: PL.concat_files(shards, cat))
    require(stats == {"records": n, "files": 4, "sorted": True}
            and filecmp.cmp(cat, src, shallow=False),
            f"split_file then concat_files gives back the file, sorted flag set: {stats}")

    sub = str(workdir / "sub.ibu")
    stats = wall(f"tools subsample_file {n_small}",
                  lambda: PL.subsample_file(src, sub, n=n_small, seed=0))
    got = np.asarray(MmapReader(sub).records)
    # the source's indices are a permutation of arange(n): where each sits
    place = np.empty(n, dtype=np.int64)
    place[records["index"].astype(np.int64)] = np.arange(n)
    at = place[got["index"].astype(np.int64)]
    require(stats == {"records": n, "sampled": n_small, "seed": 0} and len(got) == n_small
            and MmapReader(sub).header().sorted()
            and bool((np.diff(at) > 0).all()) and np.array_equal(records[at], got),
            f"subsample_file gives a sorted subset of exactly {n_small}: {stats}")

    whole, tail = n * 7 // 10 + 123, 11  # a cut 11 bytes into a record
    torn, fixed = str(workdir / "torn.ibu"), str(workdir / "fixed.ibu")
    with open(src, "rb") as f, open(torn, "wb") as out:
        out.write(f.read(32 + 24 * whole + tail))
    stats = wall("tools repair_file", lambda: PL.repair_file(torn, fixed))
    require(stats["records"] == whole and stats["dropped_bytes"] == tail and stats["sorted"]
            and np.array_equal(np.asarray(MmapReader(fixed).records), records[:whole])
            and MmapReader(fixed).header().sorted(),
            f"repair_file keeps the whole records before the cut: {stats}")
    torn_report = PL.check_file(torn)
    require(not torn_report["ok"] and torn_report["records"] == whole,
            "check_file reports the torn tail")

    part = records[:n_small]
    bc_rows, umi_rows, idx = PL.decode_batch(part, BC_LEN, UMI_LEN, engine="host")
    mixed = idx.copy()
    mixed[::3] *= np.uint64(7919)  # several digit counts in one block
    for label, index in (("one width", idx + np.uint64(10**6)), ("mixed widths", mixed)):
        text = wall(f"tools decode_tsv_block {label} {n_small}",
                     lambda: PL.decode_tsv_block(bc_rows, umi_rows, index))
        lines = text.split(b"\n")
        require(len(lines) == n_small + 1 and lines[-1] == b"", "one TSV line per record")
        for k in rng.choice(n_small, 10_000, replace=False).tolist():
            want = b"%s\t%s\t%d" % (bytes(bc_rows[k]), bytes(umi_rows[k]), int(index[k]))
            require(lines[k] == want, f"TSV line {k} is {want!r}, got {lines[k]!r}")
    return {"check": report, "allow": allow, "kept": kept, "few": few, "shards": shards,
            "cat": cat, "sub": sub, "torn": torn, "fixed": fixed}


def cli_env(**extra) -> dict:
    """The environment a user's shell gives the command: this one, without
    ``IBU_AUTO_ENGINE``."""
    return {**{k: v for k, v in os.environ.items() if k != "IBU_AUTO_ENGINE"}, **extra}


def run_cli(args: list[str], walls: dict, key: str, stdout=None, env=None):
    """``python -m ibu_tpu_torch *args`` in a new process from the root of
    the checkout, as a user types it; its wall printed and kept under
    ``key``."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "ibu_tpu_torch", *args], cwd=ROOT,
                          env=cli_env() if env is None else env,
                          stdout=subprocess.PIPE if stdout is None else stdout,
                          stderr=subprocess.PIPE, timeout=600)
    walls[key] = time.perf_counter() - t0
    log(f"wall: cli {key}: {walls[key]:.3f} s (exit {proc.returncode})")
    for line in proc.stderr.decode().splitlines():
        log(f"cli {key}: stderr: {line}")
    return proc


def cli_ok(proc, key: str, stdout: str | None = None) -> None:
    require(proc.returncode == 0, f"cli {key} exits 0")
    if stdout is not None:
        got = proc.stdout.decode()
        require(got == stdout, f"cli {key} prints {stdout!r}, got {got[:500]!r}")


def same_file(got: str, want: str, what: str) -> None:
    require(filecmp.cmp(got, want, shallow=False), f"{what}: {got} equals {want} byte for byte")
    os.unlink(got)


def tsv_lines(records: np.ndarray) -> bytes:
    return PL.decode_tsv_block(*PL.decode_batch(records, BC_LEN, UMI_LEN, engine="host"))


def cli_phase(card, wf: dict, fq: dict, workdir: Path) -> dict:
    """Phase 12: the command line, ``python -m ibu_tpu_torch``, on the files
    phases 10 and 11 leave, each command's output held against the same
    functions called in-process. Returns the codec kernels' launches under
    the CLI's codec commands."""
    t_phase = time.perf_counter()
    walls: dict = {}
    raw, src = wf["raw"], fq["src"]
    records = np.asarray(MmapReader(src).records)
    n = len(records)

    def out(name: str) -> str:
        return str(workdir / name)

    # no card: a device command refuses before it writes anything. It runs
    # on a thread beside the rest of the phase (it only sniffs the file)
    pool = ThreadPoolExecutor(4)  # this command and the three lanes below
    no_card = pool.submit(run_cli, ["stats", src, "--engine", "device"], walls,
                          "stats without a card", env=cli_env(CUDA_VISIBLE_DEVICES=""))

    # the startup floor: import, argument parsing and one header read
    tiny = write_ibu(workdir / "tiny.ibu", make_records([1], [2], [3]))
    proc = run_cli(["info", tiny], walls, "info 1 record")
    cli_ok(proc, "info 1 record")

    def workflow_reads() -> None:
        """The read-only workflow commands on phase 10's raw file."""
        path = out("sorted.ibu")
        cli_ok(run_cli(["sort", raw, path], walls, "sort native"), "sort",
               f"sorted {raw} -> {path}\n")
        same_file(path, raw, "sort of the sorted raw file")  # native.sort_file gives it back
        reader = MmapReader(raw)
        h = reader.header()
        info = {"path": raw, "magic": "IBU!", "version": h.version, "bc_len": h.bc_len,
                "umi_len": h.umi_len, "sorted": h.sorted(), "flags": h.flags,
                "records": reader.len(), "bytes": 32 + 24 * reader.len()}
        cli_ok(run_cli(["info", raw], walls, "info"), "info", json.dumps(info) + "\n")
        stats = PL.file_stats(raw, engine="native")
        stats.pop("engine")
        cli_ok(run_cli(["stats", raw], walls, "stats"), "stats", json.dumps(stats) + "\n")
        keys, counts = PL.barcode_counts(raw, engine="host", batch_records=WF_BATCH)
        order = np.lexsort((keys, -counts))[:20]
        top = "".join(f"{seq}\t{int(c)}\n"
                      for seq, c in zip(C.decode_seqs(keys[order], BC_LEN), counts[order]))
        proc = run_cli(["histogram", raw, "--top", "20"], walls, "histogram")
        cli_ok(proc, "histogram", top)
        require(proc.stderr.decode().endswith(
            f"# {len(keys)} unique barcodes, {int(counts.sum())} records\n"), "histogram's totals")
        path = out("cells.txt")
        cli_ok(run_cli(["cells", raw, "-o", path, "--engine", "device", "--method", "ordmag",
                        "--expect", str(CELLS)], walls, "cells device"), "cells")
        same_file(path, wf["cells"], "cells --engine device")

    def workflow_writes() -> tuple[str, str]:
        """The workflow commands that write files; returns ``count``'s line."""
        path = out("corrected.ibu")
        cli_ok(run_cli(["correct", raw, path, "--barcodes", wf["cells"]], walls, "correct"),
               "correct")
        same_file(path, wf["corrected"], "correct")
        path = out("molecules.ibu")
        cli_ok(run_cli(["dedup", wf["corrected"], path, "--assume-sorted", "no"], walls,
                       "dedup native sort"), "dedup")
        same_file(path, wf["molecules"], "dedup --assume-sorted no")
        proc = run_cli(["count", wf["molecules"], out("counts")], walls, "count host")
        cli_ok(proc, "count")
        require(count_trio(out("counts")) == count_trio(wf["counts"]), "count equals count_matrix")
        count_line = (proc.stdout.decode(), out("counts"))
        proc = run_cli(["count", wf["molecules"], out("counts_dev"), "--engine", "device"], walls,
                       "count device")
        err = proc.stderr.decode()
        if proc.returncode == 0:
            require(count_trio(out("counts_dev")) == count_trio(wf["counts"]),
                    "count --engine device equals the host engine")
            log("cli: count --engine device ran within max_pairs=1048576")
        else:
            require(proc.returncode == 1 and err.startswith("error: a batch produced ")
                    and err.endswith(
                        " distinct (barcode, index) pairs, over the max_pairs=1048576 device "
                        "capacity; raise it or shrink batch_records\n") and not proc.stdout,
                    f"count --engine device refuses with the reference's text: {err!r}")
            log("cli: count --engine device refused past max_pairs=1048576, exit 1, as the "
                "reference")
        return count_line

    fastq, back, tsv = out("a.fastq"), out("back.ibu"), out("decode.tsv")

    def fastq_commands() -> None:
        """The FASTQ commands and ``decode`` on phase 11's sorted file."""
        cli_ok(run_cli(["export-fastq", src, fastq], walls, "export-fastq"), "export-fastq")
        require(filecmp.cmp(fastq, fq["fastq"], shallow=False), "export-fastq equals export_fastq")
        cli_ok(run_cli(["ingest-fastq", fastq, back], walls, "ingest-fastq"), "ingest-fastq")
        os.unlink(fastq)
        same_file(back, fq["back"], "ingest-fastq")
        with open(tsv, "wb") as f:
            cli_ok(run_cli(["decode", src], walls, "decode", stdout=f), "decode")
        m = N_FASTQ_GZIP
        head, tail = tsv_lines(records[:m]), tsv_lines(records[n - m:])
        with open(tsv, "rb") as f:
            require(f.read(len(head)) == head, f"decode's first {m} lines are decode_tsv_block's")
            f.seek(-len(tail), os.SEEK_END)
            require(f.read() == tail, f"decode's last {m} lines are decode_tsv_block's")

    def file_tools_commands() -> None:
        """The file tools on phase 11's sorted file."""
        cli_ok(run_cli(["check", src, "--json"], walls, "check"), "check",
               json.dumps(fq["check"]) + "\n")
        allow = out("allow.txt")
        Path(allow).write_text("".join(f"{int(b)}\n" for b in fq["allow"]))
        path = out("kept.ibu")
        cli_ok(run_cli(["filter", src, path, "--barcodes", allow], walls, "filter"), "filter")
        same_file(path, fq["kept"], "filter")
        few = fq["few"]
        lines = "".join(f"{b}\t{u}\t{int(i)}\n" for b, u, i in zip(
            C.decode_seqs(few["barcode"], BC_LEN), C.decode_seqs(few["umi"], UMI_LEN),
            few["index"]))
        cli_ok(run_cli(["lookup", src, *(str(int(b)) for b in fq["allow"][:8])], walls,
                       "lookup"), "lookup", lines)
        cli_ok(run_cli(["split", src, out("shard{}.ibu"), "4"], walls, "split"), "split")
        for k, shard in enumerate(fq["shards"]):
            same_file(out(f"shard{k}.ibu"), shard, f"split shard {k}")
        path = out("merged.ibu")
        cli_ok(run_cli(["merge", path, *fq["shards"]], walls, "merge"), "merge")
        same_file(path, src, "merge of the sorted shards")
        path = out("cat.ibu")
        cli_ok(run_cli(["concat", path, *fq["shards"]], walls, "concat"), "concat")
        same_file(path, fq["cat"], "concat")
        path = out("sub.ibu")
        cli_ok(run_cli(["subsample", src, path, "--n", str(N_FASTQ_GZIP), "--seed", "0"], walls,
                       "subsample"), "subsample")
        same_file(path, fq["sub"], "subsample")
        path = out("fixed.ibu")
        cli_ok(run_cli(["repair", fq["torn"], path], walls, "repair"), "repair")
        same_file(path, fq["fixed"], "repair")

    def reads_and_tools() -> None:
        workflow_reads()
        file_tools_commands()

    # three lanes side by side, each command after the one before it in its
    # lane: the walls are taken with up to four commands running at once
    lanes = [pool.submit(lane) for lane in (reads_and_tools, workflow_writes, fastq_commands)]
    count_line = [lane.result() for lane in lanes][1]

    # the codec commands in this process, with the kernels' launches counted
    from ibu_tpu_torch.__main__ import main as cli_main

    def decode_into(path: str) -> int:
        with open(path, "w") as f, contextlib.redirect_stdout(f):
            return cli_main(["decode", src])

    cli_launches = {}
    with forced_engine("device"):
        reset_launches()
        rc = wall(f"cli in process decode {n}", lambda: decode_into(out("decode_in_process.tsv")))
        require(rc == 0, "decode in process exits 0")
        cli_launches["decode"] = read_launches()
        same_file(out("decode_in_process.tsv"), tsv, "decode in process and in a new process")
        os.unlink(tsv)
        reset_launches()
        rc = wall(f"cli in process export-fastq {n}", lambda: cli_main(["export-fastq", src, fastq]))
        require(rc == 0, "export-fastq in process exits 0")
        cli_launches["export-fastq"] = read_launches()
        reset_launches()
        rc = wall(f"cli in process ingest-fastq {n}", lambda: cli_main(["ingest-fastq", fastq, back]))
        require(rc == 0, "ingest-fastq in process exits 0")
        cli_launches["ingest-fastq"] = read_launches()
    log(f"launches under the CLI's codec commands: {cli_launches}")
    reader_batches = -(-n // DEFAULT_BUFFER_RECORDS)
    require(cli_launches["decode"]["decode_records"] == reader_batches
            and cli_launches["decode"]["encode_records"] == 0,
            f"decode launched decode_records once per Reader batch ({reader_batches})")
    require(cli_launches["export-fastq"]["decode_records"] == -(-n // EXPORT_BATCH)
            and cli_launches["export-fastq"]["encode_records"] == 0,
            "export-fastq launched decode_records once per 2^20-record batch")
    require(cli_launches["ingest-fastq"]["encode_records"] == -(-n // INGEST_BATCH)
            and cli_launches["ingest-fastq"]["decode_records"] == 0,
            "ingest-fastq launched encode_records once per 200,000-read batch")
    same_file(fastq, fq["fastq"], "export-fastq in process")
    same_file(back, fq["back"], "ingest-fastq in process")

    proc = no_card.result()
    pool.shutdown()
    err = proc.stderr.decode()
    require(proc.returncode == 2 and not proc.stdout and err.count("\n") == 1
            and "--device cpu" in err, f"without a card stats --engine device exits 2: {err!r}")

    log("cli: walls (one run each, a new process each, three lanes side by side): " + ", ".join(
        f"{k} {v:.3f} s" for k, v in walls.items()))
    log(f"cli: phase 12 took {time.perf_counter() - t_phase:.1f} s")
    return cli_launches, count_line


COHORT_WORLD = 2  # ranks of phase 13's cohort on the one card
DRYRUN_RECORDS = 1 << 22  # records a rank of phase 13's dry run (one stream batch)
LOADER_BATCH = 1 << 20


def cohort_commands(src: str, want: str, wf: dict, workdir: Path) -> list[dict]:
    """Phase 13's cohort commands, each ``{"key", "argv", "pod"
    (IBU_POD_SORT_ENGINE or None), "fault" (None, or what rank 1 injects)}``.
    Export comes before ingest: rank 0 concatenates the export's shards into
    ingest's input between the two."""
    def w(name: str) -> str:
        return str(workdir / name)

    cells = w("cells1000.txt")
    commands = [
        ("sort mesh", ["sort", src, w("mesh.ibu"), "--engine", "mesh"], None),
        ("sort pod host", ["sort", src, w("pod.ibu"), "--engine", "pod"], "host"),
        ("stats", ["stats", src], None),
        ("histogram", ["histogram", src, "--top", "20"], None),
        ("correct", ["correct", wf["raw"], w("corrected.ibu"), "--barcodes", wf["cells"]], None),
        ("dedup unsorted", ["dedup", wf["corrected"], w("molecules.ibu"), "--assume-sorted", "no"],
         None),
        ("dedup sorted", ["dedup", want, w("dedup.ibu")], None),
        ("filter", ["filter", want, w("filter.ibu"), "--barcodes", cells], None),
        ("filter invert", ["filter", want, w("invert.ibu"), "--barcodes", cells, "--invert"], None),
        ("count", ["count", wf["molecules"], w("counts")], None),
        ("export-fastq", ["export-fastq", want, w("cohort.fastq")], None),
        ("ingest-fastq", ["ingest-fastq", w("cohort_cat.fastq"), w("ingest.ibu"),
                          "--bc-len", str(BC_LEN), "--umi-len", str(UMI_LEN)], None),
    ]
    out = [{"key": k, "argv": a, "pod": p, "fault": None} for k, a, p in commands]
    out += [
        {"key": "fail", "argv": ["sort", src, w("fail.ibu"), "--engine", "pod"], "pod": "host",
         "fault": "run sort"},
        {"key": "fail count", "argv": ["count", wf["molecules"], w("fail_counts")], "pod": None,
         "fault": "write"},
        {"key": "lying flag", "argv": ["dedup", w("lie.ibu"), w("lie_out.ibu")], "pod": None,
         "fault": None},
    ]
    return out


def cohort_rank(rank: int, world: int, workdir: Path, device: str | None) -> int:
    """One rank of phase 13's cohort: every command of ``commands.json``
    through ``ibu_tpu_torch.__main__.main`` with ``--distributed``, under
    ``IBU_AUTO_ENGINE=device`` (the codec kernels' launches are counted per
    command), with rank 1's faults injected. Writes what each printed, its
    wall, its launches and its codec batch sizes, the exchange backend and
    this rank's share of the mesh sort to ``rank{rank}.json``."""
    import io

    import torch.distributed as dist

    from ibu_tpu_torch.__main__ import main as cli_main
    from ibu_tpu_torch.entry import dryrun_rank
    from ibu_tpu_torch.parallel import multihost as MH
    from ibu_tpu_torch.parallel import sort as MS

    commands = json.loads((workdir / "commands.json").read_text())
    os.environ["IBU_AUTO_ENGINE"] = "device"
    store = f"file://{workdir / 'store'}"
    flags = ["--distributed", "--coordinator", store,
             "--num-processes", str(world), "--process-id", str(rank)]
    result: dict = {}
    # the entry module's dry run first: it joins the cohort the commands then use
    MH.init_distributed(store, world, rank)
    reset_launches()
    t0 = time.perf_counter()
    try:
        dry = {"rc": 0, "out": json.dumps(dryrun_rank(rank, world, device, DRYRUN_RECORDS)),
               "err": ""}
    except Exception as e:  # noqa: BLE001 (the parent requires rc 0 from every rank)
        dry = {"rc": 1, "out": "", "err": f"{type(e).__name__}: {e}"}
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    result["dryrun_rank"] = {**dry, "wall": time.perf_counter() - t0, "launches": read_launches()}
    shares, sizes = [], []
    inner_sort = MS._sample_sort
    inner_encode, inner_decode = PL.encode_batch, PL.decode_batch

    def spy(*args, **kwargs):
        run, matrix = inner_sort(*args, **kwargs)
        shares.append(int(matrix[:, rank].sum()))
        return run, matrix

    def encode_spy(bc, umi, idx, *args, **kwargs):
        sizes.append(len(idx))
        return inner_encode(bc, umi, idx, *args, **kwargs)

    def decode_spy(records, *args, **kwargs):
        sizes.append(len(records))
        return inner_decode(records, *args, **kwargs)

    def boom(*args, **kwargs):
        raise OSError(f"injected failure on rank {rank}")

    MS._sample_sort, PL.encode_batch, PL.decode_batch = spy, encode_spy, decode_spy
    faults = {"run sort": (native, "sort_chunks_range"), "write": (MH, "_pwrite_all")}
    for cmd in commands:
        key, fault = cmd["key"], cmd["fault"]
        if fault and rank == 1:
            owner, name = faults[fault]
            real = getattr(owner, name)
            setattr(owner, name, boom)
        os.environ.pop("IBU_POD_SORT_ENGINE", None)
        if cmd["pod"]:
            os.environ["IBU_POD_SORT_ENGINE"] = cmd["pod"]
        out, err = io.StringIO(), io.StringIO()
        reset_launches()
        sizes.clear()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli_main(cmd["argv"] + flags + (
                ["--device", device] if device and cmd["argv"][0] != "filter" else []))
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        result[key] = {"rc": rc, "out": out.getvalue(), "err": err.getvalue(),
                       "wall": time.perf_counter() - t0, "launches": read_launches(),
                       "sizes": list(sizes)}
        if fault and rank == 1:
            setattr(owner, name, real)
        if key == "export-fastq":  # ingest's input: the shards in rank order
            if rank == 0:
                fq = Path(cmd["argv"][2])
                with open(workdir / "cohort_cat.fastq", "wb") as cat:
                    for r in range(world):
                        with open(fq.with_name(f"{fq.stem}.part{r}{fq.suffix}"), "rb") as part:
                            shutil.copyfileobj(part, cat, 1 << 24)
            dist.barrier()
    result["backend"] = MH.exchange_backend(device)
    result["share"] = shares
    (workdir / f"rank{rank}.json").write_text(json.dumps(result))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def cohort_of_one(card, src: str, want: str, workdir: Path) -> None:
    """Phase 13, leg 1: a world of one on NCCL, in this process."""
    import torch.distributed as dist

    from ibu_tpu_torch.parallel import multihost as MH
    from ibu_tpu_torch.parallel import sort as MS

    records = np.asarray(MmapReader(src).records)
    n = len(records)
    wanted = np.asarray(MmapReader(want).records)
    dist.init_process_group("nccl", init_method=f"file://{workdir / 'store1'}",
                            world_size=1, rank=0)
    try:
        backend = MH.exchange_backend(card)
        log(f"cohort: world of one: exchange backend {backend}")
        require(backend == "nccl", "a world of one with its own card exchanges over NCCL")
        got = wall(f"cohort sharded_sort_records {n} (world 1, NCCL)", lambda: MS.sharded_sort_records(
            records, device=card, bc_len=BC_LEN, umi_len=UMI_LEN, index_bits=32))
        require(got.tobytes() == wanted.tobytes(), "sharded_sort_records equals native.sort_file")
        del got
        for key, fn in (
            ("sort_file_mesh", lambda out: MS.sort_file_mesh(src, out, device=card)),
            ("multihost_sort_file mesh",
             lambda out: MH.multihost_sort_file(src, out, device=card, engine="mesh")),
            ("multihost_sort_file host",
             lambda out: MH.multihost_sort_file(src, out, device=card, engine="host")),
        ):
            out = str(workdir / "one.ibu")
            wall(f"cohort {key} {n} (world 1)", lambda: fn(out))
            same_file(out, want, f"cohort {key}")
        stats = wall(f"cohort multihost_file_stats {n} (world 1)",
                     lambda: MH.multihost_file_stats(src, device=card))
        native_stats = PL.file_stats(src, engine="native")
        native_stats.pop("engine", None)
        require(stats == native_stats, f"multihost_file_stats equals the native engine: {stats}")
        hist = wall(f"cohort multihost_barcode_histogram {n} (world 1)",
                    lambda: MH.multihost_barcode_histogram(src, device=card))
        keys, counts = PL.barcode_counts(src, engine="host")
        require(hist == dict(zip(keys.tolist(), counts.tolist())),
                "multihost_barcode_histogram equals the host engine")
    finally:
        dist.destroy_process_group()
    require(MH.process_count() == 1, "the group of one is gone after its leg")


def cohort_shapes(n: int, fastq_bytes: int) -> dict:
    """The codec batch sizes each rank of phase 13's cohort gives the record
    kernels: the export's 2^20-record batches of its record range, and the
    ingest's 200,000-read batches of the reads whose sequence line starts in
    its byte range of the concatenated FASTQ (83 bytes a read)."""
    from ibu_tpu_torch.parallel.host import partition

    def batches(count: int, batch: int) -> list[int]:
        return [batch] * (count // batch) + ([count % batch] if count % batch else [])

    seq_starts = FASTQ_READ_BYTES * np.arange(n, dtype=np.int64) + 23  # after "@r", 20 digits, \n
    out = {"export-fastq": [], "ingest-fastq": [], "export ranges": [], "ingest ranges": []}
    for (lo, hi), (blo, bhi) in zip(partition(n, COHORT_WORLD),
                                    partition(fastq_bytes, COHORT_WORLD)):
        out["export-fastq"].append(batches(hi - lo, EXPORT_BATCH))
        out["export ranges"].append((lo, hi))
        first, last = np.searchsorted(seq_starts, [blo, bhi])
        out["ingest-fastq"].append(batches(int(last - first), INGEST_BATCH))
        out["ingest ranges"].append((int(first), int(last)))
    return out


def cohort_of_two(card, src: str, want: str, wf: dict, workdir: Path) -> dict:
    """Phase 13, leg 2: two ranks on the one card, one launch of two
    processes (this script as the rank worker), every cohort command's
    output equal to the same command's in one process (or to the file an
    earlier phase made). On the card the commands name no device, as a user
    types them. Returns the codec kernels' launches per command and rank."""
    import io

    from ibu_tpu_torch.__main__ import main as cli_main

    records = np.asarray(MmapReader(want).records)
    n = len(records)
    with open(wf["cells"]) as f:
        cells = [line for line in f if line.strip()]
    (workdir / "cells1000.txt").write_text("".join(cells[:FILTER_BARCODES]))
    lie = Header.new(BC_LEN, UMI_LEN)
    lie.set_sorted()
    with open(src, "rb") as f, open(workdir / "lie.ibu", "wb") as g:
        f.seek(len(lie.as_bytes()))
        g.write(lie.as_bytes())
        shutil.copyfileobj(f, g, 1 << 24)
    commands = cohort_commands(src, want, wf, workdir)
    (workdir / "commands.json").write_text(json.dumps(commands))

    # the record kernels at the batch shapes the ranks will give them
    shapes = cohort_shapes(n, FASTQ_READ_BYTES * n)
    parts = {"export batch": records[:EXPORT_BATCH], "ingest batch": records[:INGEST_BATCH]}
    for r in range(COHORT_WORLD):
        lo, hi = shapes["export ranges"][r]
        parts[f"export rank {r} tail"] = records[hi - shapes["export-fastq"][r][-1]:hi]
        lo, hi = shapes["ingest ranges"][r]
        parts[f"ingest rank {r} last"] = records[hi - shapes["ingest-fastq"][r][-1]:hi]
    hold_record_kernels(card, parts, "cohort")

    device = [] if card.type == "cuda" else ["--device", "cpu"]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--cohort-rank", str(r), "--cohort-world",
         str(COHORT_WORLD), "--cohort-dir", str(workdir),
         *(["--cohort-device", "cpu"] if device else [])],
        cwd=ROOT, env=cli_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(COHORT_WORLD)]
    try:
        logs = [p.communicate(timeout=600)[0].decode(errors="replace") for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    log(f"wall: cohort launch of {COHORT_WORLD} ranks: {time.perf_counter() - t0:.3f} s")
    for r, (p, text) in enumerate(zip(procs, logs)):
        for line in text.splitlines()[-20:]:
            log(f"cohort rank {r}: {line}")
        require(p.returncode == 0, f"cohort rank {r} exits 0")
    ranks = [json.loads((workdir / f"rank{r}.json").read_text()) for r in range(COHORT_WORLD)]
    for r, res in enumerate(ranks):
        log(f"cohort rank {r}: exchange backend {res['backend']}; shares of the mesh sorts "
            f"{res['share']} records")
        require(res["backend"] == "gloo", "two ranks on one card exchange over Gloo")
    require(sum(ranks[r]["share"][0] for r in range(COHORT_WORLD)) == len(MmapReader(src)),
            "the ranks' shares add up to the file")
    dry = [res["dryrun_rank"] for res in ranks]
    total = COHORT_WORLD * DRYRUN_RECORDS
    for r, got in enumerate(dry):
        log(f"cohort rank {r}: dryrun_rank at {DRYRUN_RECORDS} records a rank: wall "
            f"{got['wall']:.3f} s (the join in it), launches {got['launches']}, "
            f"{got['out'] or got['err']}")
        require(got["rc"] == 0, f"cohort rank {r}: the dry run passes its checks")
        summary = json.loads(got["out"])
        require(summary["count"] == summary["all_reduced_count"] == summary["sorted"] == total,
                f"cohort rank {r}: the dry run merged and sorted {total} records")
        require(got["launches"]["encode_records"] == 1,
                f"cohort rank {r}: the dry run launched encode_records once")
    require(dry[0]["out"] == dry[1]["out"], "the dry run's ranks merged the same state")

    singles: dict = {}
    launches: dict = {"dryrun_rank": [got["launches"] for got in dry]}
    for cmd in commands:
        key, argv = cmd["key"], cmd["argv"]
        if cmd["fault"] or key == "lying flag":
            continue
        rank0, rank1 = ranks[0][key], ranks[1][key]
        require(rank0["rc"] == rank1["rc"] == 0 and rank1["out"] == "",
                f"cohort {key}: both ranks exit 0, rank 1 prints nothing on stdout")
        if key == "count":  # one process's line is phase 12's, its wall phase 10's
            line, prefix = wf["count_line"]
            require(rank0["out"] == line.replace(prefix, argv[2]),
                    f"cohort count: rank 0 prints phase 12's line ({rank0['out'][:200]!r})")
            require(count_trio(argv[2]) == count_trio(wf["counts"]),
                    "cohort count: the trio equals phase 10's host trio byte for byte")
            singles[key] = wf["count_wall"]
            continue
        os.environ.pop("IBU_POD_SORT_ENGINE", None)
        if cmd["pod"]:
            os.environ["IBU_POD_SORT_ENGINE"] = cmd["pod"]
        single = list(argv) + (device if argv[0] != "filter" else [])
        writes = argv[0] not in ("stats", "histogram")
        if writes:  # its own output file
            single[2] = argv[2].replace(".ibu", "_single.ibu").replace(".fastq", "_single.fastq")
        if key == "ingest-fastq":  # one process's export is its input
            single[1] = str(workdir / "cohort_single.fastq")
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with forced_engine("device"), contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            rc = cli_main(single)
        singles[key] = time.perf_counter() - t0
        os.environ.pop("IBU_POD_SORT_ENGINE", None)
        want_out = out.getvalue().replace("_single.ibu", ".ibu")
        require(rc == 0 and rank0["out"] == want_out, f"cohort {key}: rank 0 prints what one "
                f"process prints ({rank0['out'][:200]!r} against {want_out[:200]!r})")
        if key == "histogram":
            tail = [ln for ln in rank0["err"].splitlines() if ln.startswith("# ")]
            require(tail == [ln for ln in err.getvalue().splitlines() if ln.startswith("# ")],
                    "cohort histogram: the same totals line")
        if key in ("export-fastq", "ingest-fastq"):
            launches[key] = [ranks[r][key]["launches"] for r in range(COHORT_WORLD)]
            kernel = "decode_records" if key == "export-fastq" else "encode_records"
            for r in range(COHORT_WORLD):
                got = ranks[r][key]
                require(got["sizes"] == shapes[key][r], f"cohort {key} rank {r}: codec batches "
                        f"{got['sizes']} are the predicted {shapes[key][r]}")
                require(got["launches"][kernel] == len(shapes[key][r]),
                        f"cohort {key} rank {r}: {kernel} launched once per batch: "
                        f"{got['launches']}")
        if key == "export-fastq":
            fq = Path(argv[2])
            lo_hi = shapes["export ranges"]
            for r in range(COHORT_WORLD):
                lines = [ln for ln in ranks[r][key]["err"].splitlines() if ln.startswith("# ")]
                shard = fq.with_name(f"{fq.stem}.part{r}{fq.suffix}")
                head = [f"# exported {lo_hi[r][1] - lo_hi[r][0]} reads -> {shard} (this host's "
                        "shard)"]
                tail = [f"# pod total: {n} reads across rank-ordered part* shards"] if r == 0 else []
                require(lines == head + tail, f"cohort export-fastq rank {r} prints {lines}")
                os.unlink(shard)
            same_file(str(workdir / "cohort_cat.fastq"), single[2],
                      "cohort export-fastq: the shards in rank order")
        elif key == "ingest-fastq":
            back = records.copy()
            back["index"] = np.arange(n, dtype=np.uint64)
            header = Header.new(BC_LEN, UMI_LEN)
            header.set_sorted()
            require(Path(argv[2]).read_bytes() == header.as_bytes() + back.tobytes(),
                    "cohort ingest-fastq: the cohort's file with arange as its index column, "
                    "byte for byte")
            del back
            same_file(single[2], argv[2], "cohort ingest-fastq single process")
            os.unlink(argv[2])
        elif argv[0] == "sort":
            same_file(single[2], want, f"cohort {key} single process")
            same_file(argv[2], want, f"cohort {key}")
        elif key == "correct":
            same_file(single[2], wf["corrected"], "cohort correct single process")
            same_file(argv[2], wf["corrected"], "cohort correct")
        elif key == "dedup unsorted":
            same_file(single[2], wf["molecules"], "cohort dedup --assume-sorted no single process")
            same_file(argv[2], wf["molecules"], "cohort dedup --assume-sorted no")
        elif writes:
            same_file(argv[2], single[2], f"cohort {key}")
            os.unlink(single[2])

    fail = [res["fail"] for res in ranks]
    log(f"cohort: injected run sort failure on rank 1: exits {[f['rc'] for f in fail]}, "
        f"last lines {[f['err'].splitlines()[-1:] for f in fail]}")
    require(all(f["rc"] != 0 for f in fail) and not (workdir / "fail.ibu").exists(),
            "a failure on rank 1 ends both ranks, and no output is left")
    fail = [res["fail count"] for res in ranks]
    log(f"cohort: injected write failure on rank 1 in count: exits {[f['rc'] for f in fail]}, "
        f"last lines {[f['err'].splitlines()[-1:] for f in fail]}")
    left = [p.name for p in workdir.iterdir() if p.name.startswith("fail_counts")]
    require(all(f["rc"] != 0 for f in fail) and not left,
            f"a write failure on rank 1 ends both ranks of count, and no output is left: {left}")
    lying = [res["lying flag"] for res in ranks]
    log(f"cohort: dedup of a lying sorted flag: exits {[f['rc'] for f in lying]}, "
        f"last lines {[f['err'].splitlines()[-1:] for f in lying]}")
    require(all(f["rc"] == 1 and "not in sorted order" in f["err"].splitlines()[-1]
                for f in lying) and not (workdir / "lie_out.ibu").exists(),
            "a lying sorted flag ends both ranks of dedup with exit 1, and no output is left")
    os.unlink(workdir / "lie.ibu")
    os.unlink(workdir / "cohort_single.fastq")

    log("cohort: walls, two ranks against one process on the same file (one run each; count's "
        "one process is phase 10's count_matrix host):")
    for key, one in singles.items():
        two = max(ranks[r][key]["wall"] for r in range(COHORT_WORLD))
        log(f"cohort wall: {key}: two ranks {two:.3f} s (rank 0 {ranks[0][key]['wall']:.3f}, "
            f"rank 1 {ranks[1][key]['wall']:.3f}), one process {one:.3f} s, ratio "
            f"{two / one:.2f}")
    for key in ("fail", "fail count", "lying flag"):
        log(f"cohort wall: {key}: rank 0 {ranks[0][key]['wall']:.3f} s, rank 1 "
            f"{ranks[1][key]['wall']:.3f} s")
    return launches


def loader_leg(card, src: str) -> None:
    """Phase 13, leg 3: ``RecordLoader`` on the card at 2^20-record batches."""
    from ibu_tpu_torch.data import RecordLoader

    reader = MmapReader(src)
    n = len(reader)
    file_sums = S.checksum_records_np(np.asarray(reader.records))

    def device_sums(batches):
        sums = [S.field_sums(b) for b in batches]
        return torch.stack(sums).cpu().numpy() if sums else np.zeros((0, 3), np.int64)

    def host_sums(batches):
        return np.array([[int(s) for s in np.asarray(b).view(np.int64).reshape(-1, 3).sum(
            axis=0)] for b in batches], dtype=np.int64)

    firsts = []
    for shuffle, epochs in ((False, 1), ("global", 1), ("blocks", 2)):
        loader = RecordLoader(src, LOADER_BATCH, shuffle=shuffle, seed=SEED,
                              drop_remainder=False, device=card)
        for epoch in range(epochs):
            out = {}

            def run():
                out["sums"] = device_sums(loader.epoch(epoch))

            # the last epoch also gives the card's busy share (one profiled run)
            profiled = shuffle == "blocks" and epoch == epochs - 1
            t0 = time.perf_counter()
            ms = device_ms(run, [()], iters=1, warm=False) if profiled else run()
            dt = time.perf_counter() - t0
            got = out["sums"]
            log(f"wall: loader {shuffle or 'sequential'} epoch {epoch}: {dt:.3f} s "
                f"({n / dt / 1e6:.1f} M records/s, {len(got)} batches)")
            if profiled:
                note = "not measured" if ms is None else f"{ms:.3f} ms ({ms / (dt * 1e3):.2%} busy)"
                log(f"loader profile: blocks epoch {epoch}: device {note}, under the profiler")
            want = host_sums(loader.host_batches(epoch))
            require(np.array_equal(got, want), f"loader {shuffle} epoch {epoch}: every batch's "
                    "checksum on the card equals host_batches'")
            total = tuple(int(v) & ((1 << 64) - 1) for v in got.sum(axis=0, dtype=np.int64))
            require(len(got) == -(-n // LOADER_BATCH) and total == file_sums,
                    f"loader {shuffle} epoch {epoch} is a permutation of the file (sums exact)")
            if shuffle == "blocks":
                firsts.append(next(iter(loader.host_batches(epoch)))["index"].copy())
    require(not np.array_equal(firsts[0], firsts[1]), "the two blocks epochs differ")

    parts = []
    for k in range(2):
        loader = RecordLoader(src, LOADER_BATCH, shuffle="blocks", seed=SEED, shard_index=k,
                              shard_count=2, drop_remainder=False, device=card)
        parts.append(torch.cat(list(loader.epoch(0))))
    union = S.sort_records(torch.cat(parts), check=False)
    whole = S.sort_records(records_to_tensor(np.asarray(reader.records), card), check=False)
    require(sum(len(p) for p in parts) == n and torch.equal(union, whole),
            "shard_count=2 gives a disjoint, exact union")
    del parts, union, whole


def cohort_records(cells: str, path: str) -> None:
    """An unsorted file of :data:`N_COHORT` records: barcodes drawn from the
    called cells, 12-base UMIs and gene indices at random."""
    rng = np.random.default_rng(SEED + 13)
    with open(cells) as f:
        pool = C.encode_seqs([line.strip() for line in f if line.strip()])
    write_ibu(Path(path), make_records(
        pool[rng.integers(0, len(pool), N_COHORT)],
        rng.integers(0, 1 << (2 * UMI_LEN), N_COHORT, dtype=np.uint64),
        rng.integers(0, GENE_INDEX, N_COHORT, dtype=np.uint64)))


def cohort_phase(card, wf: dict, workdir: Path) -> dict:
    """Phase 13: the cohort layer at 10M bc16/umi12 records drawn from phase
    10's called cells: a world of one on NCCL, two ranks on the one card
    through the CLI, and the loader on the card. Returns the codec kernels'
    launches per cohort command and rank."""
    t_phase = time.perf_counter()
    workdir = workdir.resolve()  # the file:// rendezvous needs an absolute path
    src = str(workdir / "cohort.ibu")
    wall(f"cohort generate {N_COHORT} records", lambda: cohort_records(wf["cells"], src))
    want = str(workdir / "native.ibu")
    wall("cohort native.sort_file (the reference bytes)", lambda: native.sort_file(src, want))
    # leg 3 first: its profile is then taken before any group or rank exists
    t0 = time.perf_counter()
    loader_leg(card, src)
    log(f"cohort: leg 3 (RecordLoader) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cohort_of_one(card, src, want, workdir)
    log(f"cohort: leg 1 (world of one, NCCL) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches = cohort_of_two(card, src, want, wf, workdir)
    log(f"cohort: leg 2 (two ranks on one card) took {time.perf_counter() - t0:.1f} s")
    os.unlink(want)
    os.unlink(src)
    log(f"cohort: phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return launches


#: phase 14: each lab's module and its arguments
LABS_DIR = ROOT / "build" / "chip_smoke_labs"  # the stream lab's files on the checkout's disk
CAPACITY_LABS = [
    (engine_capacity_lab, []),
    (engine_capacity_lab, ["--batch-records", str(1 << 22)]),  # the stream's batch
    (histogram_capacity_lab, []),
    (histogram_capacity_lab, ["--sorted", "--bc16"]),
    (molcount_capacity_lab, ["--hints", "both"]),
    (sort_keys_lab, ["--records", str(1 << 20), str(1 << 24), "--sets", "2"]),
    (stream_lab, ["--records", "10", "--reps", "2"]),
    (stream_lab, ["--records", "10", "--reps", "2", "--phases", "e,b", "--workdir", str(LABS_DIR)]),
    (put_sweep, []),
    (put_source_lab, ["--batch-records", str(1 << 20), "--reps", "4"]),
]


def capacity_labs_phase(card) -> None:
    """Phase 14: every device-capacity and feed lab through its ``main``."""
    t_phase = time.perf_counter()
    name = torch.cuda.get_device_name(card)
    try:
        for module, argv in CAPACITY_LABS:
            lab = module.__name__.rsplit(".", 1)[1]
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = module.main(argv)
            log(f"wall: {lab} {' '.join(argv)}: {time.perf_counter() - t0:.3f} s")
            require(rc == 0, f"{lab} exited 0")
            printed = [json.loads(line) for line in out.getvalue().splitlines()]
            require(bool(printed), f"{lab} printed its JSON lines")
            for line in printed:
                require(line["device"] == name and line["timer"],
                        f"{lab}'s line names {name} and its timer")
                print(json.dumps(line), flush=True)
    finally:
        shutil.rmtree(LABS_DIR, ignore_errors=True)
    log(f"capacity labs: phase 14 took {time.perf_counter() - t_phase:.1f} s")


def entry_phase(card) -> int:
    """Phase 15: the entry point on the card, at its example and at
    config 1's size; returns ``encode_records``' launches in the phase."""
    from ibu_tpu_torch import entry as EN

    t_phase = time.perf_counter()
    reset_launches()
    fn, example = wall(f"entry() ({EN.EXAMPLE_RECORDS}-record example to the card)", EN.entry)
    require(all(t.device == card for t in example), "entry() puts its example on the card")
    host = wall(f"entry: the reference's draws at {N_MAIN} records (numpy)",
                lambda: EN._example_batch(N_MAIN))
    full = wall(f"entry: {N_MAIN} records to the card", lambda: tuple(t.to(card) for t in host))
    del host
    for args in (example, full):
        n = len(args[2])
        records, sums = wall(f"entry fn at {n} records (encode_records and field_sums)",
                             lambda: fn(*args))
        require(torch.equal(records, K.plain_encode_records(*args)),
                f"entry fn at {n} records: the records equal the plain version")
        host_records = records_from_tensor(records)
        want = [int(host_records[f].sum(dtype=np.uint64)) for f in ("barcode", "umi", "index")]
        got = [int(v) & U64_MASK for v in sums.tolist()]
        require(got == want, f"entry fn at {n} records: the sums {got} equal numpy's {want}")
        del records, sums, host_records
    launches = K.encode_records.launches
    log(f"entry: launches {read_launches()}")
    require(launches == 2, "entry fn launched encode_records once per step")
    log(f"entry: phase 15 took {time.perf_counter() - t_phase:.1f} s")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    card = torch.device("cuda", 0)
    t_start = time.perf_counter()
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
    report = lib.with_suffix(".log")
    for line in report.read_text().splitlines() if report.exists() else ["(no ptxas report)"]:
        if "registers" in line or "spill" in line or "entry function" in line:
            log(f"ptxas: {line.strip()}")

    t0 = time.perf_counter()
    n_checks = check_kernels(card, N_CHECK)
    log(f"kernel checks: {n_checks} exact matches against the plain versions "
        f"({time.perf_counter() - t0:.2f} s)")

    workdir = ROOT / "build" / "chip_smoke"
    workdir.mkdir(parents=True, exist_ok=True)
    try:
        main_path(card, N_MAIN, N_SORTED, workdir)
        record_launches = {name: KERNELS[name][0].launches
                           for name in ("encode_records", "decode_records")}
        log(f"launches on the record path: {record_launches}")
        require(all(v > 0 for v in record_launches.values()),
                "both record kernels ran on the record path")
        launches = matrix_phase(card)
        reset_launches()
        histogram_path(card, N_MAIN, workdir)
        log(f"launches on the histogram path (torch ops, no codec kernel): {read_launches()}")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    kernels = time_kernels(card, N_MAIN, launches)
    kernels += labs_phase(card, N_MAIN)
    kernels += sort_lab_phase(card, N_SORT_LAB)
    # phases 10 and 11 keep their files for phase 12, which reads them
    dirs = {name: workdir / name for name in ("workflow", "fastq", "cli", "cohort")}
    try:
        for d in dirs.values():
            d.mkdir(parents=True, exist_ok=True)
        wf_files = workflow_phase(card, N_READS, dirs["workflow"])
        log(f"elapsed before the FASTQ phase: {time.perf_counter() - t_start:.1f} s")
        fastq_launches, fq_files = fastq_phase(card, N_FASTQ, N_FASTQ_GZIP, dirs["fastq"])
        os.environ.pop("IBU_AUTO_ENGINE", None)
        log(f"launches on the FASTQ path (device legs): {fastq_launches}")
        log(f"elapsed before the CLI phase: {time.perf_counter() - t_start:.1f} s")
        cli_launches, count_line = cli_phase(card, wf_files, fq_files, dirs["cli"])
        log(f"elapsed before the cohort phase: {time.perf_counter() - t_start:.1f} s")
        cohort_launches = cohort_phase(card, {**wf_files, "count_line": count_line},
                                       dirs["cohort"])
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
        os.environ.pop("IBU_AUTO_ENGINE", None)
    log(f"elapsed before the capacity labs: {time.perf_counter() - t_start:.1f} s")
    capacity_labs_phase(card)
    log(f"elapsed before the entry phase: {time.perf_counter() - t_start:.1f} s")
    entry_launches = {"phase 15": entry_phase(card),
                      "dryrun_rank": [got["encode_records"]
                                      for got in cohort_launches["dryrun_rank"]]}
    for entry in kernels:
        name = entry["name"]
        if name == "encode_records":
            entry["entry_launches"] = entry_launches
        if name in ("encode_records", "decode_records"):
            entry["fastq_launches"] = fastq_launches[name]
            entry["cli_launches"] = {cmd: got[name] for cmd, got in cli_launches.items()
                                     if got[name]}
            entry["cohort_launches"] = {cmd: [got[name] for got in per_rank]
                                        for cmd, per_rank in cohort_launches.items()
                                        if any(got[name] for got in per_rank)}
    log(f"elapsed: total {time.perf_counter() - t_start:.1f} s (the rule: under 420 s)")
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
    if "--cohort-rank" in sys.argv:  # one rank of phase 13's cohort
        import argparse

        ap = argparse.ArgumentParser()
        for flag in ("--cohort-rank", "--cohort-world"):
            ap.add_argument(flag, type=int, required=True)
        ap.add_argument("--cohort-dir", type=Path, required=True)
        ap.add_argument("--cohort-device", default=None)
        a = ap.parse_args()
        sys.exit(cohort_rank(a.cohort_rank, a.cohort_world, a.cohort_dir, a.cohort_device))
    sys.exit(main())
