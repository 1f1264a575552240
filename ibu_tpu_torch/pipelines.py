"""High-level pipelines: sequences ↔ sorted IBU files in one call, file
statistics and per-barcode counts.

Counterpart of :mod:`ibu_tpu.pipelines` for the record and histogram paths:
the same signatures and return types, with ``engine`` in ``{"device",
"host"}`` and a ``device`` argument (see
:func:`ibu_tpu_torch.utils.device.resolve_device`). On a CUDA device the
codec runs the hand-written kernels of :mod:`ibu_tpu_torch.ops.codec_cuda`;
on the CPU it runs their plain torch versions.

Compressed (gzip/zstd) files reach the device histogram engines as host
batches, as the JAX package's ``histogram`` command feeds them::

    DeviceHistogram(device=...).run(Reader.from_path(path).batches())
    sharded_barcode_histogram(Reader.from_path(path).batches(), device=...)
"""

from __future__ import annotations

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
from ibu_tpu_torch.ops.stats import group_sum_np, sort_records
from ibu_tpu_torch.ops.u64 import (
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


def file_stats(
    path: str, engine: str = "device", device: str | torch.device | None = None
) -> dict:
    """Count + exact field checksums of a whole file. ``"device"`` streams
    the file to the device (:func:`ibu_tpu_torch.parallel.device.stream_file_stats`);
    ``"native"`` runs the native host engine
    (:func:`ibu_tpu_torch.native.checksum_parallel`). The returned dict names
    the engine that ran under ``"engine"``."""
    _require_plain(path, "stats")
    reader = MmapReader(path)
    n = reader.len()
    if engine == "native":
        if not native.available():
            raise RuntimeError(f"native runtime unavailable: {native.load_error()}")
        bc, umi, idx = native.checksum_parallel(path, n)
        stats = {"count": n, "barcode_sum": bc, "umi_sum": umi, "index_sum": idx}
    elif engine == "device":
        from ibu_tpu_torch.parallel.device import stream_file_stats

        stats = stream_file_stats(reader, device=device)
    else:
        raise ValueError(f"engine must be 'device' or 'native', got {engine!r}")
    return {**stats, "engine": engine}


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
