"""High-level pipelines: sequences ↔ sorted IBU files in one call, file
statistics, per-barcode counts, and the single-cell workflow after ingest
(cells → correct → dedup → count, with the device file sort).

Counterpart of :mod:`ibu_tpu.pipelines` for these paths: the same
signatures, defaults, return dicts and error texts, plus a ``device``
argument wherever a call touches torch (see
:func:`ibu_tpu_torch.utils.device.resolve_device`). On a CUDA device the
codec runs the hand-written kernels of :mod:`ibu_tpu_torch.ops.codec_cuda`;
on the CPU it runs their plain torch versions. The engines the reference
names ``"host"`` (``count_matrix``, ``call_cells`` and ``barcode_counts``
by default, ``file_stats(engine="host")``) are numpy, as there.

Compressed (gzip/zstd) files reach the device histogram engines as host
batches, as the JAX package's ``histogram`` command feeds them::

    DeviceHistogram(device=...).run(Reader.from_path(path).batches())
    sharded_barcode_histogram(Reader.from_path(path).batches(), device=...)
"""

from __future__ import annotations

import contextlib
import os
import struct
import tempfile

import numpy as np
import torch

from ibu_tpu_torch import native
from ibu_tpu_torch.constructs.header import Header
from ibu_tpu_torch.constructs.record import make_records
from ibu_tpu_torch.io.compression import sniff_compression
from ibu_tpu_torch.io.mmap import MmapReader
from ibu_tpu_torch.io.writer import Writer
from ibu_tpu_torch.ops import codec as C
from ibu_tpu_torch.ops.codec_cuda import decode_records, encode_records
from ibu_tpu_torch.ops.stats import group_sum_np, pair_molecule_counts, sort_records
from ibu_tpu_torch.ops.u64 import (
    U64_MASK,
    records_from_tensor,
    records_to_tensor,
    to_device,
    to_host,
    u64_as_int64,
)
from ibu_tpu_torch.utils.device import resolve_device


def _check_engine(engine: str) -> None:
    if engine not in ("device", "host"):
        raise ValueError(f"engine must be 'device' or 'host', got {engine!r}")


def _rows_to_device(rows: np.ndarray, device: torch.device) -> torch.Tensor:
    return to_device(np.ascontiguousarray(rows, dtype=np.uint8), device)


def encode_batch(
    bc_rows: np.ndarray,
    umi_rows: np.ndarray,
    index: np.ndarray,
    engine: str = "device",
    device: str | torch.device | None = None,
) -> np.ndarray:
    """ASCII rows ``(N, bc_len)`` + ``(N, umi_len)`` + ``uint64`` indices →
    structured record array. ``"host"`` runs the native host codec
    (:mod:`ibu_tpu_torch.native`; numpy where it is not built); the
    numerics are the same either way."""
    _check_engine(engine)
    if engine == "host":
        if native.available():
            bc = native.pack_2bit(np.ascontiguousarray(bc_rows), validate=False)
            umi = native.pack_2bit(np.ascontiguousarray(umi_rows), validate=False)
        else:
            bc = C.np_pack(bc_rows)
            umi = C.np_pack(umi_rows)
        return make_records(bc, umi, np.asarray(index, dtype=np.uint64))
    device = resolve_device(device)
    records = encode_records(
        _rows_to_device(bc_rows, device),
        _rows_to_device(umi_rows, device),
        to_device(u64_as_int64(index), device),
    )
    return records_from_tensor(records)


def decode_batch(
    records: np.ndarray,
    bc_len: int,
    umi_len: int,
    engine: str = "device",
    device: str | torch.device | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Structured records → ASCII rows ``(N, bc_len)``, ``(N, umi_len)``,
    and the ``uint64`` index column."""
    _check_engine(engine)
    if engine == "host":
        bc_words = np.ascontiguousarray(records["barcode"])
        umi_words = np.ascontiguousarray(records["umi"])
        if native.available():
            bc_rows = native.unpack_2bit(bc_words, bc_len)
            umi_rows = native.unpack_2bit(umi_words, umi_len)
        else:
            bc_rows = C.np_unpack(bc_words, bc_len)
            umi_rows = C.np_unpack(umi_words, umi_len)
        return bc_rows, umi_rows, np.asarray(records["index"])
    device = resolve_device(device)
    bc, umi, index = decode_records(
        records_to_tensor(records, device), bc_len, umi_len
    )
    return to_host(bc), to_host(umi), to_host(index).view(np.uint64)


def sort_batch(
    records: np.ndarray,
    bc_len: int | None = None,
    umi_len: int | None = None,
    index_bits: int | None = None,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Device lexicographic sort of a structured record array; the hints
    shorten the sort keys and a violated hint raises
    (:func:`ibu_tpu_torch.ops.stats.sort_records`)."""
    device = resolve_device(device)
    return records_from_tensor(
        sort_records(records_to_tensor(records, device), bc_len, umi_len, index_bits)
    )


def encode_sorted_file(
    path: str,
    bc_seqs: list[str] | np.ndarray,
    umi_seqs: list[str] | np.ndarray,
    index: np.ndarray | None = None,
    validate: bool = True,
    device: str | torch.device | None = None,
) -> Header:
    """Sequences → device encode → device sort → sorted IBU file. The data
    crosses to the device once as ASCII + index and comes back once as
    sorted records. Returns the written header (sorted flag set).

    The sort hints need no data check: the encoder zeroes hi words of fields
    of at most 16 bases, and a caller's ``index`` is scanned on the host.
    """
    bc_rows = bc_seqs if isinstance(bc_seqs, np.ndarray) else C.seqs_to_rows(bc_seqs)
    umi_rows = (
        umi_seqs if isinstance(umi_seqs, np.ndarray) else C.seqs_to_rows(umi_seqs)
    )
    if validate:
        C.np_validate_ascii(bc_rows)
        C.np_validate_ascii(umi_rows)
    n = len(bc_rows)
    if len(umi_rows) != n:
        raise ValueError(f"{n} barcodes but {len(umi_rows)} UMIs")
    if index is None:
        index = np.arange(n, dtype=np.uint64)
        index_hi_zero = n <= (1 << 32)
    else:
        index = np.asarray(index, dtype=np.uint64)
        index_hi_zero = not (index >> np.uint64(32)).any()
    bc_len, umi_len = bc_rows.shape[1], umi_rows.shape[1]
    device = resolve_device(device)
    records = encode_records(
        _rows_to_device(bc_rows, device),
        _rows_to_device(umi_rows, device),
        to_device(u64_as_int64(index), device),
    )
    srt = sort_records(
        records, bc_len, umi_len, 32 if index_hi_zero else None, check=False
    )
    header = Header.new(bc_len, umi_len)
    header.set_sorted()
    with Writer.from_path(path, header) as w:
        w.write_batch(records_from_tensor(srt))
    return header


def decode_file(
    path: str, as_strings: bool = False, device: str | torch.device | None = None
) -> tuple[Header, np.ndarray | list[str], np.ndarray | list[str], np.ndarray]:
    """IBU file → ``(header, bc, umi, index)``: ASCII row arrays (or string
    lists with ``as_strings=True``) and the ``uint64`` indices."""
    reader = MmapReader(path)
    header = reader.header()
    bc_rows, umi_rows, index = decode_batch(
        np.asarray(reader.records), header.bc_len, header.umi_len, device=device
    )
    if as_strings:
        return header, C.rows_to_seqs(bc_rows), C.rows_to_seqs(umi_rows), index
    return header, bc_rows, umi_rows, index


def _require_plain(path: str, tool: str) -> None:
    """Raise a clear error when a tool that maps its input gets a gzip/zstd
    file (same text as :mod:`ibu_tpu.pipelines`)."""
    with open(path, "rb") as f:
        kind = sniff_compression(f.read(4))
    if kind is not None:
        raise ValueError(
            f"{path} is {kind}-compressed; {tool} needs random access into "
            "the record region — decompress it first (e.g. `python -m "
            f"ibu_tpu concat plain.ibu {path}`)"
        )


@contextlib.contextmanager
def _removed_on_error(path: str):
    """Delete ``path`` if the wrapped copy fails: a writer that validates
    mid-copy must not leave a half-written output whose header claims (the
    sorted flag) downstream tools would trust."""
    try:
        yield
    except BaseException:
        try:
            os.unlink(path)
        except OSError:
            pass
        raise


def sort_file_device(
    in_path: str,
    out_path: str,
    index_bits: int | None = None,
    device: str | torch.device | None = None,
) -> Header:
    """Sorted rewrite of an IBU file using the device sort.

    Loads the whole file, copies the records to the device as ``(N, 3)``
    int64, sorts with hi-word hints from the header (and a host scan of the
    index hi words when ``index_bits`` is not given), and writes with the
    input's flags and the sorted flag set. Returns the written header.
    """
    _require_plain(in_path, "sort")
    device = resolve_device(device)
    reader = MmapReader(in_path)
    header = reader.header()
    records = np.asarray(reader.records)
    if index_bits is None:
        # one host pass over the idx hi words; buys a smaller sort key
        index_bits = 32 if not (records["index"] >> np.uint64(32)).any() else None
    # check stays on: a file whose records violate its own header (hi bits
    # set beyond bc_len/umi_len) raises rather than losing those bits
    srt = sort_records(
        records_to_tensor(records, device), header.bc_len, header.umi_len, index_bits
    )
    out_header = Header.new(header.bc_len, header.umi_len)
    out_header.flags = header.flags
    out_header.set_sorted()
    with Writer.from_path(out_path, out_header) as w:
        w.write_batch(records_from_tensor(srt))
    return out_header


def host_stream_stats(batches) -> dict:
    """Count + exact u64 field checksums over an iterator of structured
    record batches, pure numpy: uint64 column sums wrap mod 2^64, which is
    the checksum's arithmetic."""
    n = 0
    sums = [0, 0, 0]
    for batch in batches:
        batch = np.asarray(batch)
        n += len(batch)
        for i, f in enumerate(("barcode", "umi", "index")):
            sums[i] = (sums[i] + int(batch[f].sum(dtype=np.uint64))) & U64_MASK
    return {"count": n, "barcode_sum": sums[0], "umi_sum": sums[1], "index_sum": sums[2]}


def host_file_stats(reader: MmapReader, batch_records: int = 4 * 1024 * 1024) -> dict:
    """:func:`host_stream_stats` over a whole mapped file."""
    n = reader.len()
    return host_stream_stats(
        reader.slice(start, min(start + batch_records, n))
        for start in range(0, n, batch_records)
    )


def file_stats(
    path: str, engine: str = "device", device: str | torch.device | None = None
) -> dict:
    """Count + exact field checksums of a whole file. ``"device"`` streams
    the file to the device (:func:`ibu_tpu_torch.parallel.device.stream_file_stats`);
    ``"native"`` runs the native host engine
    (:func:`ibu_tpu_torch.native.checksum_parallel`); ``"host"`` runs
    :func:`host_file_stats` (numpy). The returned dict names the engine that
    ran under ``"engine"``."""
    _require_plain(path, "stats")
    reader = MmapReader(path)
    n = reader.len()
    if engine == "native":
        if not native.available():
            raise RuntimeError(f"native runtime unavailable: {native.load_error()}")
        bc, umi, idx = native.checksum_parallel(path, n)
        stats = {"count": n, "barcode_sum": bc, "umi_sum": umi, "index_sum": idx}
    elif engine == "host":
        stats = host_file_stats(reader)
    elif engine == "device":
        from ibu_tpu_torch.parallel.device import stream_file_stats

        stats = stream_file_stats(reader, device=device)
    else:
        raise ValueError(f"engine must be device/native/host, got {engine!r}")
    return {**stats, "engine": engine}


# ---------------------------------------------------------------------------
# UMI deduplication (molecule-level rewrite)
# ---------------------------------------------------------------------------


def _lex_nondecreasing(
    bc: np.ndarray, umi: np.ndarray, idx: np.ndarray,
    prev: tuple[int, int, int] | None,
) -> bool:
    """Whether (bc, umi, idx) triples are lexicographically nondecreasing
    within the batch and against the previous batch's last record."""
    b0, b1 = bc[:-1], bc[1:]
    u0, u1 = umi[:-1], umi[1:]
    i0, i1 = idx[:-1], idx[1:]
    ok = np.all((b1 > b0) | ((b1 == b0) & ((u1 > u0) | ((u1 == u0) & (i1 >= i0)))))
    if not ok:
        return False
    if prev is not None and len(bc):
        if (int(bc[0]), int(umi[0]), int(idx[0])) < prev:
            return False
    return True


def _dedup_batch_masks(bc, umi, prev):
    """Per-batch dedup masks against a one-record carry: ``(keep,
    bc_first)``, ``keep[i]`` marking the first record of a distinct
    (barcode, umi) pair and ``bc_first[i]`` the first of a distinct barcode,
    both relative to ``prev`` (``(bc, umi, idx)`` ints, or None at the
    start)."""
    keep = np.empty(len(bc), dtype=bool)
    keep[1:] = (bc[1:] != bc[:-1]) | (umi[1:] != umi[:-1])
    keep[0] = prev is None or (int(bc[0]) != prev[0] or int(umi[0]) != prev[1])
    bc_first = np.empty(len(bc), dtype=bool)
    bc_first[1:] = bc[1:] != bc[:-1]
    bc_first[0] = prev is None or int(bc[0]) != prev[0]
    return keep, bc_first


def dedup_file(
    in_path: str,
    out_path: str,
    batch_records: int = 4 * 1024 * 1024,
    assume_sorted: bool | None = None,
    device: str | torch.device | None = None,
) -> dict:
    """Collapse PCR duplicates: keep ONE record per distinct (barcode, umi)
    pair.

    In sort order duplicates of a pair are adjacent and the first carries
    the minimum index, so a sorted file streams in one pass: a keep-mask per
    batch plus a one-record carry across batch boundaries. An unsorted input
    is first sorted on ``device`` (:func:`sort_file_device`) into a temporary
    file. (The JAX package prefers its native external merge sort there; the
    output bytes are the same either way, because records with equal
    (barcode, umi, index) triples are identical.) Order is verified batch by
    batch during the pass, so a file with a lying sorted flag raises; pass
    ``assume_sorted=False`` to force the sort, or ``True`` to trust an unset
    flag.

    The output header copies the input's flags and sets the sorted flag.
    Returns ``{"records": N, "molecules": M, "barcodes": B}``.
    """
    _require_plain(in_path, "dedup_file")
    reader = MmapReader(in_path)
    header = reader.header()
    sorted_in = header.sorted() if assume_sorted is None else assume_sorted

    tmp = None
    if not sorted_in:
        fd, tmp = tempfile.mkstemp(suffix=".ibu", dir=os.path.dirname(os.path.abspath(out_path)))
        os.close(fd)
        try:
            sort_file_device(in_path, tmp, device=device)
            reader = MmapReader(tmp)
        except BaseException:
            os.unlink(tmp)
            raise

    out_header = Header.new(header.bc_len, header.umi_len)
    out_header.flags = header.flags
    out_header.set_sorted()

    n = reader.len()
    records = molecules = barcodes = 0
    prev: tuple[int, int, int] | None = None
    try:
        with _removed_on_error(out_path), Writer.from_path(out_path, out_header) as w:
            for start in range(0, n, batch_records):
                batch = np.asarray(reader.slice(start, min(start + batch_records, n)))
                bc, umi, idx = batch["barcode"], batch["umi"], batch["index"]
                if not _lex_nondecreasing(bc, umi, idx, prev):
                    raise ValueError(
                        f"{in_path}: records are not in sorted order near "
                        f"record {start} despite the sorted flag; re-sort, "
                        "or pass assume_sorted=False (CLI: "
                        "--assume-sorted no)"
                    )
                keep, bc_first = _dedup_batch_masks(bc, umi, prev)
                w.write_batch(batch[keep])
                records += len(batch)
                molecules += int(keep.sum())
                barcodes += int(bc_first.sum())
                prev = (int(bc[-1]), int(umi[-1]), int(idx[-1]))
    finally:
        if tmp is not None:
            os.unlink(tmp)
    return {"records": records, "molecules": molecules, "barcodes": barcodes}


def _batch_uniques(batches):
    for batch in batches:
        yield np.unique(np.asarray(batch)["barcode"], return_counts=True)


def host_stream_histogram(batches) -> dict[int, int]:
    """Barcode → count over an iterator of structured record batches, pure
    host numpy: ``np.unique`` per batch and one final group-sum (the merge
    of :func:`barcode_counts`'s host engine)."""
    keys, counts = group_sum_np(_batch_uniques(batches))
    return dict(zip(keys.tolist(), counts.tolist()))


def barcode_counts(
    in_path: str,
    engine: str = "host",
    batch_records: int = 4 * 1024 * 1024,
    max_uniques_per_shard: int = 1 << 16,
    device: str | torch.device | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-barcode read counts of a whole file: ``(barcodes, counts)``,
    uint64 and int64, by ascending barcode. ``"host"`` streams ``np.unique``
    per mmap batch; ``"device"`` runs
    :func:`ibu_tpu_torch.parallel.device.sharded_barcode_histogram`, taking
    the sorted fast path when the header says the file is sorted."""
    _require_plain(in_path, "barcode_counts")
    reader = MmapReader(in_path)
    from ibu_tpu_torch.parallel.device import (
        record_batches_from_mmap,
        sharded_barcode_histogram,
    )

    batches = record_batches_from_mmap(reader, batch_records)
    if engine == "device":
        hist = sharded_barcode_histogram(
            batches,
            device=device,
            max_uniques_per_shard=max_uniques_per_shard,
            sorted_in=reader.header().sorted(),
        )
        barcodes = np.fromiter(hist.keys(), dtype=np.uint64, count=len(hist))
        counts = np.fromiter(hist.values(), dtype=np.int64, count=len(hist))
        order = np.argsort(barcodes, kind="stable")
        return barcodes[order], counts[order]
    if engine != "host":
        raise ValueError(f"engine must be 'host' or 'device', got {engine!r}")
    return group_sum_np(_batch_uniques(batches))


# ---------------------------------------------------------------------------
# cell calling (rank-count knee → barcode allowlist)
# ---------------------------------------------------------------------------


def call_cells(
    in_path: str,
    out_path: str,
    method: str = "knee",
    expect: int = 3000,
    min_count: int = 1,
    engine: str = "host",
    batch_records: int = 4 * 1024 * 1024,
    device: str | torch.device | None = None,
) -> dict:
    """Call cell barcodes from the rank-count curve and write an allowlist.

    One histogram pass over the file (:func:`barcode_counts` with ``engine``
    and, for ``"device"``, ``device``), then the knee / order-of-magnitude
    estimator of :mod:`ibu_tpu_torch.ops.knee` picks the count threshold.
    The output file is one ACGT sequence per line, descending by count: the
    allowlist format that :func:`correct_file` consumes. Returns
    ``{"records", "barcodes", "cells", "threshold", "method"}``.
    """
    from ibu_tpu_torch.ops.knee import call_from_counts

    _require_plain(in_path, "cells")  # name the user-facing tool
    bc_len = MmapReader(in_path).header().bc_len
    barcodes, counts = barcode_counts(
        in_path, engine=engine, batch_records=batch_records, device=device
    )
    cells, threshold = call_from_counts(
        barcodes, counts, method=method, expect=expect, min_count=min_count
    )
    with open(out_path, "w") as f:
        f.writelines(s + "\n" for s in C.decode_seqs(cells, bc_len))
    return {
        "records": int(counts.sum()),
        "barcodes": int(len(barcodes)),
        "cells": int(len(cells)),
        "threshold": int(threshold),
        "method": method,
    }


# ---------------------------------------------------------------------------
# count matrix (barcode × index molecule counts)
# ---------------------------------------------------------------------------


def _device_pair_counts(
    reader: MmapReader,
    batch_records: int,
    max_pairs: int,
    device: torch.device,
) -> tuple[np.ndarray, np.ndarray]:
    """Device engine of :func:`count_matrix` (dedup semantics): per batch a
    hinted sort and segment count on the device
    (:func:`ibu_tpu_torch.ops.stats.pair_molecule_counts`), then a host merge
    of the pairs.

    The input must be in sort order: equal records (PCR duplicates) are then
    adjacent, so the only cross-batch double count is a duplicate triple
    straddling a batch boundary, fixed by comparing the boundary records.
    Order is verified during the pass.

    Returns ``(pairs, counts)``: a ``(P, 2)`` uint64 array of distinct
    (barcode, index) pairs and their int64 counts.
    """
    n = reader.len()
    cap = min(max_pairs, 1 << 14)  # grown on demand (see below)
    acc_pairs: list[np.ndarray] = []
    acc_counts: list[np.ndarray] = []
    prev: tuple[int, int, int] | None = None
    prev_rec = None
    for start in range(0, n, batch_records):
        batch = np.asarray(reader.slice(start, min(start + batch_records, n)))
        bc, umi, idx = batch["barcode"], batch["umi"], batch["index"]
        if not _lex_nondecreasing(bc, umi, idx, prev):
            raise ValueError(
                f"count_matrix(engine='device') needs a sorted input, but "
                f"records are out of order near record {start}; sort "
                "first, or use engine='host'"
            )
        prev = (int(bc[-1]), int(umi[-1]), int(idx[-1]))
        # hints verified against the data per batch (one host max() per
        # column), not trusted from the header: a corrupt out-of-range field
        # would otherwise mis-group silently
        bc_hint = 16 if int(bc.max(initial=0)) < 1 << 32 else None
        umi_hint = 16 if int(umi.max(initial=0)) < 1 << 32 else None
        idx_bits = 32 if int(idx.max(initial=0)) < 1 << 32 else None
        # the table costs O(capacity), so it starts small and grows to the
        # next power of two at or above the observed pair count (one retried
        # batch per growth); max_pairs is the ceiling
        records = records_to_tensor(batch, device)
        while True:
            pair_keys, counts, num_pairs = pair_molecule_counts(
                records, cap, bc_len=bc_hint, umi_len=umi_hint, index_bits=idx_bits
            )
            got = int(num_pairs)
            if got <= cap:
                break
            if got > max_pairs:
                raise ValueError(
                    f"a batch produced {got} distinct (barcode, index) "
                    f"pairs, over the max_pairs={max_pairs} device "
                    "capacity; raise it or shrink batch_records"
                )
            cap = min(max_pairs, 1 << (got - 1).bit_length())
        pair_keys, counts = to_host(pair_keys), to_host(counts)
        valid = counts != 0
        # boundary fix: a duplicate triple straddling the batch edge was
        # counted as "first" in both batches
        if prev_rec is not None and len(batch) and batch[0] == prev_rec:
            acc_pairs.append(np.array([[batch[0]["barcode"], batch[0]["index"]]], np.uint64))
            acc_counts.append(np.array([-1], np.int64))
        acc_pairs.append(pair_keys[valid].view(np.uint64))
        acc_counts.append(counts[valid])
        prev_rec = batch[-1] if len(batch) else prev_rec

    pairs = np.concatenate(acc_pairs) if acc_pairs else np.empty((0, 2), np.uint64)
    counts = np.concatenate(acc_counts) if acc_counts else np.empty(0, np.int64)
    # aggregate duplicate pairs across batches and apply the -1 boundary
    # corrections; numeric pair values come from first occurrences
    # (np.unique on the raw byte view sorts by LE bytes, not numerically)
    view = np.ascontiguousarray(pairs).view("V16").ravel()
    uniq, inv = np.unique(view, return_inverse=True)
    summed = np.zeros(len(uniq), np.int64)
    np.add.at(summed, inv, counts)
    first_idx = np.full(len(uniq), len(inv), np.int64)
    np.minimum.at(first_idx, inv, np.arange(len(inv)))
    out_pairs = pairs[first_idx]
    keep = summed != 0
    return out_pairs[keep], summed[keep]


def _group_keys(
    keys: np.ndarray, fields: list[str], weights=None
) -> tuple[np.ndarray, np.ndarray]:
    """Unique rows of a structured key array and per-row multiplicity sums
    (lexsort and adjacent difference), in numeric-lexicographic order of
    ``fields``."""
    if len(keys) == 0:
        return keys, np.zeros(0, dtype=np.int64)
    order = np.lexsort(tuple(keys[f] for f in reversed(fields)))
    s = keys[order]
    first = np.ones(len(s), dtype=bool)
    first[1:] = s[1:] != s[:-1]
    starts = np.flatnonzero(first)
    w = (
        np.ones(len(s), dtype=np.int64)
        if weights is None
        else np.asarray(weights, dtype=np.int64)[order]
    )
    return s[starts], np.add.reduceat(w, starts)


def _count_range_partial(
    reader: MmapReader,
    lo: int,
    hi: int,
    dedup: bool,
    batch_records: int,
    in_path: str,
    boundary_carry: bool = False,
):
    """Streaming count pass over records ``[lo, hi)``: ``(keys, weights)``,
    with ``dedup`` the range-unique ``(barcode, index, umi)`` triples and
    ``weights=None``; without, the range's unique ``(barcode, index)`` pairs
    and their read counts.

    Sorted inputs (header flag) take the O(n) adjacent-difference triple
    unique: duplicates of a triple are identical records, hence adjacent in
    sort order (verified during the pass; a lying flag raises).
    ``boundary_carry=True`` also dedups against the record just before
    ``lo``.
    """
    header = reader.header()
    fields = ["barcode", "index"] + (["umi"] if dedup else [])
    key_dtype = [(f, "<u8") for f in fields]
    fast_sorted = dedup and header.sorted()
    records = reader.records
    parts: list[np.ndarray] = []
    part_counts: list[np.ndarray] = []  # dedup=False: multiplicities
    prev: tuple[int, int, int] | None = None
    if fast_sorted and boundary_carry and lo > 0 and hi > lo:
        r = records[lo - 1]
        prev = (int(r["barcode"]), int(r["umi"]), int(r["index"]))
    for start in range(lo, hi, batch_records):
        batch = np.asarray(records[start:min(start + batch_records, hi)])
        keys = np.empty(len(batch), dtype=key_dtype)
        for f in fields:
            keys[f] = batch[f]
        if fast_sorted:
            bc, um, ix = batch["barcode"], batch["umi"], batch["index"]
            if not _lex_nondecreasing(bc, um, ix, prev):
                raise ValueError(
                    f"{in_path}: the header claims sorted order but "
                    "records are out of order; re-sort first (`python "
                    "-m ibu_tpu sort`) or clear the flag (`repair`)"
                )
            first = np.ones(len(keys), dtype=bool)
            first[1:] = keys[1:] != keys[:-1]
            if prev is not None and len(batch):
                first[0] = (int(bc[0]), int(um[0]), int(ix[0])) != prev
            parts.append(keys[first])
            if len(batch):
                prev = (int(bc[-1]), int(um[-1]), int(ix[-1]))
        elif dedup:
            # triple uniquing is idempotent, so per-batch + final global
            # unique collapses cross-batch duplicates exactly
            parts.append(_group_keys(keys, fields)[0])
        else:
            u, c = _group_keys(keys, fields)
            parts.append(u)
            part_counts.append(c)

    merged = np.concatenate(parts) if parts else np.empty(0, dtype=key_dtype)
    if dedup:
        if not fast_sorted:
            merged = _group_keys(merged, fields)[0]
        return merged, None
    weights = np.concatenate(part_counts) if part_counts else np.empty(0, np.int64)
    return _group_keys(merged, fields, weights=weights)


def _count_pairs_from_partials(
    key_parts: list, weight_parts: list, dedup: bool, presorted: bool
):
    """Merge range-partial count tables (:func:`_count_range_partial`) into
    the final unique ``(barcode, index)`` pairs and counts. ``presorted=True``
    says the concatenated dedup triples are already globally unique."""
    merged = (
        np.concatenate(key_parts)
        if key_parts
        else np.empty(0, dtype=[("barcode", "<u8"), ("index", "<u8")])
    )
    pair_dtype = [("barcode", "<u8"), ("index", "<u8")]
    if dedup:
        fields = ["barcode", "index", "umi"]
        triples = merged if presorted else _group_keys(merged, fields)[0]
        pairs = np.empty(len(triples), dtype=pair_dtype)
        pairs["barcode"] = triples["barcode"]
        pairs["index"] = triples["index"]
        return _group_keys(pairs, ["barcode", "index"])
    weights = np.concatenate(weight_parts) if weight_parts else np.empty(0, np.int64)
    return _group_keys(merged, ["barcode", "index"], weights=weights)


def count_matrix(
    in_path: str,
    out_prefix: str,
    batch_records: int = 4 * 1024 * 1024,
    dedup: bool = True,
    engine: str = "host",
    max_pairs: int = 1 << 20,
    device: str | torch.device | None = None,
) -> dict:
    """Build the barcode × index molecule-count matrix.

    With ``dedup=True`` (default) the entry ``M[barcode, index]`` is the
    number of DISTINCT ``(barcode, umi, index)`` triples: reads sharing all
    three are PCR duplicates of one molecule. ``dedup=False`` counts raw
    reads per ``(barcode, index)`` pair.

    ``engine="host"`` streams numpy per batch (sorted inputs take one O(n)
    adjacent-difference pass, order verified; a lying sorted flag raises).
    ``engine="device"`` (sorted inputs, dedup semantics only) runs one
    hinted sort and segment count per batch on ``device``
    (:func:`ibu_tpu_torch.ops.stats.pair_molecule_counts`) and keeps only
    the sparse pair table on the host. The device table starts at 2^14 slots
    and grows on demand; ``max_pairs`` is the ceiling past which a batch
    raises.

    Output (MatrixMarket sparse trio, 1-based coordinates):

    * ``{out_prefix}.mtx``          — ``rows = barcodes``, ``cols = indices``
    * ``{out_prefix}.barcodes.txt`` — row labels as ACGT sequences
    * ``{out_prefix}.indices.txt``  — column labels as integer index values

    Returns ``{"barcodes", "indices", "entries", "molecules", "records"}``.
    """
    if engine not in ("host", "device"):
        raise ValueError(f"engine must be 'host' or 'device', got {engine!r}")
    if engine == "device" and not dedup:
        raise ValueError(
            "engine='device' implements dedup semantics only; raw-read "
            "counting uses engine='host'"
        )
    _require_plain(in_path, "count_matrix")
    reader = MmapReader(in_path)
    header = reader.header()
    n = reader.len()

    if engine == "device":
        dev_pairs, counts = _device_pair_counts(
            reader, batch_records, max_pairs, resolve_device(device)
        )
        pair_bc, pair_idx = dev_pairs[:, 0], dev_pairs[:, 1]
    else:
        keys, weights = _count_range_partial(reader, 0, n, dedup, batch_records, in_path)
        # a single whole-file range is already globally unique whatever the
        # input order, so the triple re-unique is skipped
        uniq_pairs, counts = _count_pairs_from_partials(
            [keys], [weights] if weights is not None else [],
            dedup=dedup, presorted=dedup,
        )
        pair_bc, pair_idx = uniq_pairs["barcode"], uniq_pairs["index"]

    return _write_count_outputs(
        out_prefix, in_path, dedup, header.bc_len, pair_bc, pair_idx, counts, n
    )


def _format_mtx_entries(row1, col1, wcounts) -> str:
    """1-based MatrixMarket entry lines as one string (one str conversion
    and a join)."""
    block = np.empty((len(row1), 3), dtype=np.int64)
    block[:, 0] = row1
    block[:, 1] = col1
    block[:, 2] = wcounts
    rows_txt = block.astype("U20").tolist()
    return "\n".join(" ".join(r) for r in rows_txt) + "\n"


def _write_count_outputs(
    out_prefix: str,
    in_path: str,
    dedup: bool,
    bc_len: int,
    pair_bc: np.ndarray,
    pair_idx: np.ndarray,
    counts,
    n: int,
) -> dict:
    """Assemble and write the MatrixMarket trio from the unique pair table."""
    barcodes = np.unique(pair_bc)
    indices = np.unique(pair_idx)
    counts = np.asarray(counts)
    row = np.searchsorted(barcodes, pair_bc)
    col = np.searchsorted(indices, pair_idx)
    # deterministic entry order (row-major) whatever the engine
    order = np.lexsort((col, row))
    row, col = row[order], col[order]
    wcounts = counts[order]

    with open(f"{out_prefix}.mtx", "w") as f:
        f.write("%%MatrixMarket matrix coordinate integer general\n")
        f.write("%rows=barcodes cols=record-indices "
                f"source={in_path} dedup={dedup}\n")
        f.write(f"{len(barcodes)} {len(indices)} {len(pair_bc)}\n")
        if len(pair_bc):
            f.write(_format_mtx_entries(row + 1, col + 1, wcounts))
    with open(f"{out_prefix}.barcodes.txt", "w") as f:
        f.writelines(s + "\n" for s in C.decode_seqs(barcodes, bc_len))
    with open(f"{out_prefix}.indices.txt", "w") as f:
        f.writelines(f"{int(i)}\n" for i in indices)

    return {
        "barcodes": int(len(barcodes)),
        "indices": int(len(indices)),
        "entries": int(len(pair_bc)),
        "molecules": int(counts.sum()),
        "records": n,
    }


# ---------------------------------------------------------------------------
# barcode error correction
# ---------------------------------------------------------------------------


def correct_file(
    in_path: str,
    out_path: str,
    barcodes,
    batch_records: int = 4 * 1024 * 1024,
    keep_unmatched: bool = False,
    device: str | torch.device | None = None,
) -> dict:
    """Correct sequencing errors in barcodes against an allowlist (Hamming
    distance ≤ 1; policy in :mod:`ibu_tpu_torch.ops.correct`).

    Per record: an exact allowlist barcode is kept; a barcode with exactly
    one allowlist entry at Hamming distance 1 is rewritten to it; anything
    else is dropped (or passed through unchanged with
    ``keep_unmatched=True``). Streams with O(batch) memory; the Hamming
    probe runs once per unique barcode per batch on ``device``
    (:func:`ibu_tpu_torch.ops.correct.correct_batch`).

    Correction rewrites barcode values, so the output's sorted flag is set
    only when the written stream was seen to be nondecreasing during the
    pass. Returns ``{"records", "exact", "corrected", "dropped",
    "allowlist"}``.
    """
    from ibu_tpu_torch.ops.correct import CORRECTED, DROP, EXACT, correct_batch

    allow = np.unique(np.asarray(list(barcodes), dtype=np.uint64))
    _require_plain(in_path, "correct_file")
    device = resolve_device(device)
    reader = MmapReader(in_path)
    header = reader.header()
    out_header = Header.new(header.bc_len, header.umi_len)

    n = reader.len()
    exact = corrected = dropped = written = 0
    observed_sorted = True
    prev: tuple[int, int, int] | None = None
    with _removed_on_error(out_path):
        with Writer.from_path(out_path, out_header) as w:
            for start in range(0, n, batch_records):
                batch = np.asarray(reader.slice(start, min(start + batch_records, n))).copy()
                fixed, status = correct_batch(
                    batch["barcode"], allow, header.bc_len, device=device
                )
                batch["barcode"] = fixed
                keep = np.ones(len(batch), dtype=bool) if keep_unmatched else status != DROP
                out = batch[keep]
                exact += int(np.count_nonzero(status == EXACT))
                corrected += int(np.count_nonzero(status == CORRECTED))
                dropped += int(np.count_nonzero(status == DROP))
                if observed_sorted and len(out):
                    if not _lex_nondecreasing(out["barcode"], out["umi"], out["index"], prev):
                        observed_sorted = False
                    prev = (int(out["barcode"][-1]), int(out["umi"][-1]), int(out["index"][-1]))
                w.write_batch(out)
                written += len(out)
    if observed_sorted and written > 0:
        # patch the observed-order flag after the copy
        out_header.set_sorted()
        with open(out_path, "r+b") as f:
            f.seek(16)
            f.write(struct.pack("<Q", out_header.flags))
    return {
        "records": n,
        "exact": exact,
        "corrected": corrected,
        "dropped": dropped,
        "allowlist": int(len(allow)),
    }
