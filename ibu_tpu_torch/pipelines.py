"""High-level pipelines: sequences ↔ sorted IBU files in one call, FASTQ
ingest and export, file statistics, per-barcode counts, the single-cell
workflow after ingest (cells → correct → dedup → count, with the device file
sort), and the host file tools (filter, lookup, split, check, concat, repair,
subsample).

Counterpart of :mod:`ibu_tpu.pipelines` for these paths: the same
signatures, defaults, return dicts and error texts, plus a ``device``
argument wherever a call touches torch (see
:func:`ibu_tpu_torch.utils.device.resolve_device`). Torch is imported by the
calls that use it, not by the module, so a host engine (``count_matrix``'s
default, ``dedup_file`` with the native sort, ``file_stats(engine="native")``)
starts without it. On a CUDA device the
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

from typing import TYPE_CHECKING

import numpy as np

from ibu_tpu_torch import native
from ibu_tpu_torch.constructs.header import HEADER_SIZE, Header
from ibu_tpu_torch.constructs.record import (
    RECORD_DTYPE,
    RECORD_SIZE,
    make_records,
    records_from_bytes,
)
from ibu_tpu_torch.errors import CompressionError, IbuError, IbuIoError, TruncatedRecord
from ibu_tpu_torch.io.compression import (
    DECOMPRESSION_ERRORS,
    as_buffered,
    infer_compression,
    open_compressed,
    open_decompressed,
    sniff_compression,
)
from ibu_tpu_torch.io.mmap import MmapReader
from ibu_tpu_torch.io.reader import Reader
from ibu_tpu_torch.io.writer import Writer
from ibu_tpu_torch.ops import codec as C
from ibu_tpu_torch.utils import trace

if TYPE_CHECKING:
    import torch


def _codec_engine(engine: str, device: str | torch.device | None) -> str:
    """``"auto"`` resolved through
    :func:`ibu_tpu_torch.parallel.select.auto_codec_engine`; any other name
    must be one of the two codec engines."""
    if engine == "auto":
        from ibu_tpu_torch.parallel.select import auto_codec_engine

        return auto_codec_engine(device=device)
    if engine not in ("device", "host"):
        raise ValueError(f"engine must be 'auto', 'device' or 'host', got {engine!r}")
    return engine


def _rows_to_device(rows: np.ndarray, device: torch.device) -> torch.Tensor:
    from ibu_tpu_torch.ops.u64 import to_device

    return to_device(np.ascontiguousarray(rows, dtype=np.uint8), device)


def encode_batch(
    bc_rows: np.ndarray,
    umi_rows: np.ndarray,
    index: np.ndarray,
    engine: str = "auto",
    device: str | torch.device | None = None,
) -> np.ndarray:
    """ASCII rows ``(N, bc_len)`` + ``(N, umi_len)`` + ``uint64`` indices →
    structured record array.

    ``engine="auto"`` (default) routes by the memoized transport probe
    (:func:`ibu_tpu_torch.parallel.select.auto_codec_engine`): the device
    codec pays about 64 B of link traffic per record, the threaded native
    host codec none. ``"device"`` runs the codec kernel on ``device``;
    ``"host"`` the native host codec (:mod:`ibu_tpu_torch.native`; numpy
    where it is not built). The numerics are the same either way."""
    with trace.span("ibu.encode_batch"):
        trace.count("records", len(bc_rows))
        engine = _codec_engine(engine, device)
        if engine == "host":
            if native.available():
                bc = native.pack_2bit(np.ascontiguousarray(bc_rows), validate=False)
                umi = native.pack_2bit(np.ascontiguousarray(umi_rows), validate=False)
            else:
                bc = C.np_pack(bc_rows)
                umi = C.np_pack(umi_rows)
            return make_records(bc, umi, np.asarray(index, dtype=np.uint64))
        from ibu_tpu_torch.ops.codec_cuda import encode_records
        from ibu_tpu_torch.ops.u64 import records_from_tensor, to_device, u64_as_int64
        from ibu_tpu_torch.utils.device import resolve_device

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
    engine: str = "auto",
    device: str | torch.device | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Structured records → ASCII rows ``(N, bc_len)``, ``(N, umi_len)``,
    and the ``uint64`` index column. Engine selection as in
    :func:`encode_batch`."""
    with trace.span("ibu.decode_batch"):
        trace.count("records", len(records))
        engine = _codec_engine(engine, device)
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
        from ibu_tpu_torch.ops.codec_cuda import decode_records
        from ibu_tpu_torch.ops.u64 import records_to_tensor, to_host
        from ibu_tpu_torch.utils.device import resolve_device

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
    with trace.span("ibu.sort_batch"):
        trace.count("records", len(records))
        from ibu_tpu_torch.ops.stats import sort_records
        from ibu_tpu_torch.ops.u64 import records_from_tensor, records_to_tensor
        from ibu_tpu_torch.utils.device import resolve_device

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
    from ibu_tpu_torch.ops.codec_cuda import encode_records
    from ibu_tpu_torch.ops.stats import sort_records
    from ibu_tpu_torch.ops.u64 import records_from_tensor, to_device, u64_as_int64
    from ibu_tpu_torch.utils.device import resolve_device

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
    file (the reference's text, naming this package's command)."""
    with open(path, "rb") as f:
        kind = sniff_compression(f.read(4))
    if kind is not None:
        raise ValueError(
            f"{path} is {kind}-compressed; {tool} needs random access into "
            "the record region — decompress it first (e.g. `python -m "
            f"ibu_tpu_torch concat plain.ibu {path}`)"
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
    from ibu_tpu_torch.ops.stats import sort_records
    from ibu_tpu_torch.ops.u64 import records_from_tensor, records_to_tensor
    from ibu_tpu_torch.utils.device import resolve_device

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


# ---------------------------------------------------------------------------
# FASTQ export and ingest, TSV text, file split
# ---------------------------------------------------------------------------

#: decimal digits in a zero-padded u64 read name (max u64 is 20 digits).
_NAME_DIGITS = 20


def _fastq_block(
    bc_rows: np.ndarray, umi_rows: np.ndarray, index: np.ndarray, qual: int
) -> bytes:
    """Assemble one FASTQ byte block, fully vectorized (no per-read Python).

    Every read is fixed-width: ``@r<20-digit index>\\n<bc+umi>\\n+\\n<qual>\\n``,
    so the whole batch is one ``(N, W)`` uint8 matrix filled by broadcasting.
    """
    n = len(bc_rows)
    bc_len, umi_len = bc_rows.shape[1], umi_rows.shape[1]
    seq_len = bc_len + umi_len
    width = 2 + _NAME_DIGITS + 1 + seq_len + 1 + 1 + 1 + seq_len + 1
    # every constant column ('@r', zero padding, newlines, '+', qual) comes
    # from ONE broadcast copy of a template row: row-contiguous fills, not
    # per-column strided byte writes
    tmpl = np.zeros(width, dtype=np.uint8)
    tmpl[0] = ord("@")
    tmpl[1] = ord("r")
    tmpl[2 : 2 + _NAME_DIGITS] = ord("0")
    c = 2 + _NAME_DIGITS
    tmpl[c] = ord("\n")
    c += 1 + seq_len
    tmpl[c] = ord("\n")
    tmpl[c + 1] = ord("+")
    tmpl[c + 2] = ord("\n")
    tmpl[c + 3 : c + 3 + seq_len] = qual
    tmpl[width - 1] = ord("\n")
    block = np.broadcast_to(tmpl, (n, width)).copy()
    # numpy's u64 vector division has no SIMD path, and indices rarely need
    # more than 8 of the 20 digit columns: the template zero-fills the
    # padding, so divide only the significant columns, in u32 when the
    # batch's largest index allows
    mx = int(index.max()) if n else 0
    sig = max(1, len(str(mx)))
    if mx <= 0xFFFFFFFF:
        p = (10 ** np.arange(sig - 1, -1, -1)).astype(np.uint32)
        digits = (index.astype(np.uint32)[:, None] // p) % np.uint32(10)
    else:
        p = np.uint64(10) ** np.arange(sig - 1, -1, -1, dtype=np.uint64)
        digits = (index[:, None] // p) % np.uint64(10)
    col = 2 + _NAME_DIGITS - sig
    block[:, col : col + sig] += digits.astype(np.uint8)  # '0' + digit
    col = 2 + _NAME_DIGITS + 1
    block[:, col : col + bc_len] = bc_rows
    block[:, col + bc_len : col + seq_len] = umi_rows
    return block.tobytes()


#: 10^1 .. 10^19: digit-count boundaries for u64 decimal formatting
_POW10 = np.uint64(10) ** np.arange(1, 20, dtype=np.uint64)


def decode_tsv_block(
    bc_rows: np.ndarray, umi_rows: np.ndarray, index: np.ndarray
) -> bytes:
    """Assemble ``<bc>\\t<umi>\\t<index>\\n`` TSV lines, fully vectorized.

    The ``decode`` command's output format. Unlike :func:`_fastq_block` the
    decimal index is variable-width (no zero padding), so rows are ragged.
    Rows are grouped by digit count (one ``searchsorted`` against the
    powers-of-ten table): each group is a RECTANGULAR line matrix, built
    contiguous with digits computed at exactly the group's width, and
    scattered to its ragged output offsets with int32 indices. When every
    index has the same width (sequential-index exports) the whole batch is
    one fixed-width matrix and ``tobytes``, with no scatter at all.
    """
    n = len(bc_rows)
    if n == 0:
        return b""
    bc_len, umi_len = bc_rows.shape[1], umi_rows.shape[1]
    prefix = bc_len + 1 + umi_len + 1  # bc \t umi \t

    def line_matrix(b, u, sub, d):
        w = prefix + d + 1
        lm = np.empty((len(b), w), dtype=np.uint8)
        lm[:, :bc_len] = b
        lm[:, bc_len] = ord("\t")
        lm[:, bc_len + 1 : bc_len + 1 + umi_len] = u
        lm[:, prefix - 1] = ord("\t")
        if d <= 9:  # group values < 10^d < 2^32: u32 division
            p = (10 ** np.arange(d - 1, -1, -1)).astype(np.uint32)
            digits = (sub.astype(np.uint32)[:, None] // p) % np.uint32(10)
        else:
            p = np.uint64(10) ** np.arange(d - 1, -1, -1, dtype=np.uint64)
            digits = (sub[:, None] // p) % np.uint64(10)
        lm[:, prefix : prefix + d] = digits.astype(np.uint8) + ord("0")
        lm[:, w - 1] = ord("\n")
        return lm

    # significant digit count (>= 1 so index 0 prints as "0")
    ndig = (np.searchsorted(_POW10, index, side="right") + 1).astype(np.int32)
    groups = np.unique(ndig)
    if len(groups) == 1:  # fixed-width fast path: one matrix, no scatter
        return line_matrix(bc_rows, umi_rows, index, int(groups[0])).tobytes()
    out_w = (prefix + ndig + 1).astype(np.int64)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(out_w, out=offsets[1:])
    out = np.empty(int(offsets[-1]), dtype=np.uint8)
    # int32 offsets halve the scatter-index traffic while the total stays
    # under 2 GiB; guard anyway
    offs = (
        offsets[:-1].astype(np.int32)
        if offsets[-1] < (1 << 31)
        else offsets[:-1]
    )
    for d in groups:
        d = int(d)
        rows = np.flatnonzero(ndig == d).astype(np.int64)
        tidx = offs[rows][:, None] + np.arange(
            prefix + d + 1, dtype=offs.dtype
        )
        out[tidx] = line_matrix(
            bc_rows[rows], umi_rows[rows], index[rows], d
        )
    return out.tobytes()


def export_fastq(
    ibu_path: str,
    fastq_path: str,
    batch_records: int = 1 << 20,
    qual: str = "I",
    record_range: tuple[int, int] | None = None,
    device: str | torch.device | None = None,
) -> int:
    """IBU file → FASTQ, the inverse of FASTQ ingestion.

    Each record becomes one read named ``@r<index, zero-padded>`` whose
    sequence is the decoded barcode followed by the UMI (the prefix layout
    :func:`ingest_fastq` parses, so ingest(export(f)) == f up to index
    renumbering). Quality is the constant ``qual`` character. ``.gz`` output
    paths are gzip-compressed. Returns the read count.

    Decode runs batch by batch through :func:`decode_batch` with its default
    engine (on ``device`` when the device codec is chosen); FASTQ assembly is
    a vectorized byte-matrix fill. No per-read Python in either stage.

    ``record_range=(start, end)`` exports only that record slice (plain
    inputs only: compressed inputs have no random access).
    """
    # Phred+33 printable range only: anything outside '!'..'~' (notably
    # '\n' or '@') would structurally corrupt the 4-line FASTQ framing.
    if len(qual) != 1 or not 0x21 <= ord(qual) <= 0x7E:
        raise ValueError(
            f"qual must be a single printable Phred+33 character "
            f"('!'..'~'), got {qual!r}"
        )
    with open(ibu_path, "rb") as f:
        kind = sniff_compression(f.read(4))
    if kind is not None and record_range is not None:
        raise ValueError(
            f"{ibu_path} is {kind}-compressed; record_range needs random "
            "access — decompress first"
        )
    if kind is None:
        reader = MmapReader(ibu_path)
        h = reader.header()

        def batches():
            lo, hi = record_range or (0, len(reader))
            for start in range(lo, hi, batch_records):
                stop = min(start + batch_records, hi)
                if stop > start:
                    yield np.asarray(reader.slice(start, stop))
    else:  # gzip/zstd input: sequential decode through the Reader
        r = Reader.from_path(ibu_path)
        h = r.header()

        def batches():
            # honor batch_records by re-chunking the Reader's fixed-size
            # refills (fewer, larger decode calls)
            pend: list[np.ndarray] = []
            have = 0
            for chunk in r.batches():
                pend.append(chunk)
                have += len(chunk)
                if have >= batch_records:
                    yield np.concatenate(pend)
                    pend, have = [], 0
            if pend:
                yield np.concatenate(pend)
    qbyte = ord(qual)
    n = 0
    # the engine is chosen, and a device engine's device looked up, before
    # the output is created: without a card nothing is written
    engine = _codec_engine("auto", device)
    if engine == "device":
        from ibu_tpu_torch.utils.device import resolve_device

        device = resolve_device(device)
    with open_compressed(fastq_path) as out:
        for recs in batches():
            bc_rows, umi_rows, idx = decode_batch(
                recs, h.bc_len, h.umi_len, engine=engine, device=device
            )
            out.write(_fastq_block(bc_rows, umi_rows, idx, qbyte))
            n += len(recs)
    return n


def split_file(
    in_path: str, out_template: str, n_shards: int
) -> list[str]:
    """Partition an IBU file into ``n_shards`` standalone IBU files.

    Shard boundaries follow the reference's contiguous remainder-to-last
    rule (:func:`ibu_tpu_torch.parallel.host.partition`). Each output
    carries a full copy of the input header (a sorted input yields sorted
    shards, so ``split`` → per-shard work → ``native.merge_files``
    roundtrips). ``out_template`` is formatted with the shard number (e.g.
    ``"shard{}.ibu"``). Zero-copy: each shard is one mmap slice handed to
    one writer.
    """
    from ibu_tpu_torch.parallel.host import partition

    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if out_template.format(0) == out_template.format(1):
        raise ValueError(
            f"out_template {out_template!r} must vary with the shard "
            "number (add '{}' or a format field)"
        )
    _require_plain(in_path, "split")
    reader = MmapReader(in_path)
    header = reader.header()
    bounds = partition(len(reader), n_shards)
    paths = []
    for shard, (start, end) in enumerate(bounds):
        path = out_template.format(shard)
        with Writer.from_path(path, header) as w:
            if end > start:
                w.write_batch(reader.slice(start, end))
        paths.append(path)
    return paths


def fastq_prefix_batches(
    path: str, prefix_len: int, batch: int = 200_000,
    chunk_bytes: int = 1 << 23,
    byte_range: tuple[int, int] | None = None,
    line_base: int = 0,
):
    """Yield ``(N, prefix_len)`` ASCII arrays of FASTQ read prefixes.

    Compression (gzip/zstd) is detected by magic-byte sniffing, the same
    convention as :func:`ibu_tpu_torch.io.compression.open_decompressed`: a
    gzipped FASTQ without a ``.gz`` suffix works. Reads shorter than
    ``prefix_len`` raise a clear error (slicing them would otherwise smuggle
    newline bytes into barcodes or fail the reshape with an opaque message).

    Parsing is vectorized: ``chunk_bytes`` blocks are scanned for newlines
    and every 4th line's prefix is gathered in one pass, by the native parser
    (:func:`ibu_tpu_torch.native.fastq_gather`) when it is built and by
    numpy otherwise, with no per-read Python. Both release the GIL inside
    their loops, so the ingest prefetch thread overlaps parsing with
    encoding.

    ``byte_range=(start, end)`` parses only the lines whose FIRST byte lies
    in ``[start, end)``: ``start`` must itself be a line start, and the last
    owned line is consumed to its real end even past ``end`` (how one FASTQ
    is split across workers without splitting a line). ``line_base`` is the
    global index of the line at ``start``, keeping the every-4th-line phase
    and the 1-based line numbers in errors correct. Plain files only (no
    random access into compressed streams).
    """
    if byte_range is not None:
        with open(path, "rb") as probe:
            kind = sniff_compression(probe.read(4))
        if kind is not None:
            raise ValueError(
                f"{path} is {kind}-compressed; byte_range needs random "
                "access — decompress first"
            )

    take = np.arange(prefix_len)
    pend: list[np.ndarray] = []  # parsed row blocks awaiting batch emit
    pn = 0

    def _rows_from(arr, starts, ends, first_lineno):
        """Prefix rows for the sequence lines among lines
        ``first_lineno + i`` spanning ``[starts[i], ends[i])`` of ``arr``."""
        lineno = first_lineno + np.arange(len(starts))
        seq = (lineno & 3) == 1
        if not seq.any():
            return None
        s, e = starts[seq], ends[seq]
        # content length excludes a trailing \r (CRLF input)
        content = e - s - (arr[np.maximum(e - 1, 0)] == 13)
        short = content < prefix_len
        if short.any():
            k = int(np.flatnonzero(short)[0])
            raise ValueError(
                f"read at line {int(lineno[seq][k]) + 1} is "
                f"{int(content[k])} bases, shorter than "
                f"bc_len+umi_len={prefix_len}"
            )
        return arr[s[:, None] + take]

    def _emit_ready():
        nonlocal pend, pn
        while pn >= batch:
            block = pend[0] if len(pend) == 1 else np.concatenate(pend)
            yield np.ascontiguousarray(block[:batch])
            pend, pn = [block[batch:]], pn - batch

    # the native chunk parser takes the hot loop when built; behaviour
    # (rows, carry, byte-range cut, line numbers, the exact short-read
    # message) is identical, and the tests run both
    use_native = native.available()

    def _native_rows(data, cap):
        nonlocal line_base
        rows, consumed, lines, capped, err_line, err_content = (
            native.fastq_gather(data, line_base, prefix_len, cap)
        )
        if err_line >= 0:
            raise ValueError(
                f"read at line {err_line + 1} is {err_content} bases, "
                f"shorter than bc_len+umi_len={prefix_len}"
            )
        line_base += lines
        return rows, consumed, capped

    carry = b""
    abs0 = byte_range[0] if byte_range else 0  # file offset of carry start
    end_byte = byte_range[1] if byte_range else None
    done = False
    # byte_range is verified-plain above: open raw (the sniffing wrapper
    # is not seekable), seek straight to the aligned start
    opener = (
        (lambda: open(path, "rb"))
        if byte_range is not None
        else (lambda: as_buffered(open_decompressed(path)))
    )
    with opener() as f:
        if byte_range:
            f.seek(byte_range[0])
        while not done:
            chunk = f.read(chunk_bytes)
            if not chunk:
                break
            data = carry + chunk if carry else chunk
            if use_native:
                cap = (
                    None if end_byte is None else max(end_byte - abs0, 0)
                )
                rows, consumed, done = _native_rows(data, cap)
                carry = data[consumed:]
                abs0 += consumed
                if len(rows):
                    pend.append(rows)
                    pn += len(rows)
                    yield from _emit_ready()
                continue
            arr = np.frombuffer(data, dtype=np.uint8)
            nl = np.flatnonzero(arr == 10)
            if len(nl) == 0:
                carry = data
                continue
            starts = np.concatenate(([0], nl[:-1] + 1))
            n_lines = len(starts)
            if end_byte is not None:
                # lines whose FIRST byte is past the range end belong to
                # the next shard; the last owned one still ends at its nl
                n_lines = int(np.searchsorted(starts, end_byte - abs0))
                done = n_lines < len(starts)
            carry = data[int(nl[-1]) + 1:]
            rows = _rows_from(
                arr, starts[:n_lines], nl[:n_lines], line_base
            )
            line_base += n_lines
            abs0 += int(nl[-1]) + 1
            if rows is not None:
                pend.append(rows)
                pn += len(rows)
                yield from _emit_ready()
    if carry and not done and (end_byte is None or abs0 < end_byte):
        # final line without a trailing newline
        if use_native:
            rows, _, _ = _native_rows(bytes(carry) + b"\n", None)
            if len(rows):
                pend.append(rows)
                pn += len(rows)
        else:
            arr = np.frombuffer(carry, dtype=np.uint8)
            rows = _rows_from(
                arr, np.array([0]), np.array([len(arr)]), line_base
            )
            if rows is not None:
                pend.append(rows)
                pn += len(rows)
    yield from _emit_ready()
    if pn:
        block = pend[0] if len(pend) == 1 else np.concatenate(pend)
        yield np.ascontiguousarray(block[:pn])


def _unlink_all(paths: list[str]) -> None:
    for path in paths:
        try:
            os.unlink(path)
        except OSError:
            pass


def ingest_fastq(
    fastq_path: str,
    ibu_path: str,
    bc_len: int,
    umi_len: int,
    batch: int = 200_000,
    validate: bool = True,
    device: str | torch.device | None = None,
) -> int:
    """FASTQ → sorted IBU file: the inverse of :func:`export_fastq`.

    Read prefixes carry the barcode (first ``bc_len`` bases) then the UMI
    (next ``umi_len``), 10x-style; the record index is the read number.
    Batches are parsed on a background thread and encoded through
    :func:`encode_batch` with its default engine (on ``device`` when the
    device codec is chosen). Sorting is out-of-core: encoded batches
    accumulate to 32 MB chunks that are sorted in RAM
    (:func:`ibu_tpu_torch.native.sort_records`) and spilled as sorted
    headerless runs, then one key-range-parallel merge
    (:func:`ibu_tpu_torch.native.merge_runs_interval`) writes the final file,
    so memory stays bounded at one chunk for arbitrarily large FASTQs.
    Without the native runtime the records accumulate in memory and are
    sorted on ``device`` (:func:`sort_batch`); both flows write the same
    bytes. The sorted flag is set. Returns the read count. No per-read
    Python in the hot path.

    A ``.gz``/``.zst`` output path yields compressed output, matching
    :func:`export_fastq` and ``Writer.from_path(compression="auto")`` (the
    merge emits a plain sibling that is then stream-compressed into place).
    """
    from ibu_tpu_torch.io.stream import thread_prefetched

    prefix_len = bc_len + umi_len
    header = Header.new(bc_len, umi_len)
    out_compression = infer_compression(ibu_path)
    out_of_core = native.available()
    if not out_of_core:
        from ibu_tpu_torch.utils.device import resolve_device

        device = resolve_device(device)  # the sort below needs it: fail early
    chunk_records = 32 * 1024 * 1024 // RECORD_SIZE  # the external sort's default
    all_records: list = []
    run_paths: list[str] = []
    pend: list = []
    pend_n = 0
    total = 0

    def _spill(chunk: list) -> None:
        # concatenating copies the batches (views of pinned transfer buffers
        # on a card) into one pageable array, sorted in place
        merged = np.concatenate(chunk) if len(chunk) > 1 else chunk[0]
        merged = native.sort_records(np.ascontiguousarray(merged))
        rp = f"{ibu_path}.ingest.run{len(run_paths)}"
        # track BEFORE writing: a tofile torn by ENOSPC/interrupt must
        # still be unlinked by the cleanup path
        run_paths.append(rp)
        merged.tofile(rp)  # headerless sorted run

    try:
        # parse and decompress the NEXT batches on a background thread while
        # this one encodes and spills: gzip FASTQ inflation is CPU-bound and
        # otherwise serializes with the encode
        for prefixes in thread_prefetched(
            fastq_prefix_batches(fastq_path, prefix_len, batch), depth=2
        ):
            if validate:
                C.np_validate_ascii(prefixes)  # reject N's etc. clearly
            n = len(prefixes)
            idx = np.arange(total, total + n, dtype=np.uint64)
            records = encode_batch(
                prefixes[:, :bc_len], prefixes[:, bc_len:], idx, device=device
            )
            if out_of_core:
                pend.append(records)
                pend_n += n
                if pend_n >= chunk_records:
                    _spill(pend)
                    pend, pend_n = [], 0
            else:
                all_records.append(records)
            total += n
        if out_of_core and pend:
            _spill(pend)
            pend = []
    except BaseException:
        # BaseException: a Ctrl-C mid-ingest must not strand up to the
        # input's size in .ingest.run* spill files
        _unlink_all(run_paths)
        raise

    if out_of_core:
        # the merge writes plain bytes; compress into place afterward
        # when the output extension asks for it
        sort_dst = ibu_path + ".sorted" if out_compression else ibu_path
        try:
            header.set_sorted()
            with open(sort_dst, "wb") as f:
                f.write(header.as_bytes())
                f.truncate(HEADER_SIZE + RECORD_SIZE * total)
            native.merge_runs_interval(
                run_paths, (0, 0, 0), None, sort_dst, HEADER_SIZE,
                expect_records=total,
            )
            if out_compression:
                try:
                    with open(sort_dst, "rb") as src, open_compressed(
                        ibu_path, out_compression
                    ) as dst:
                        while chunk := src.read(1 << 22):
                            dst.write(chunk)
                finally:
                    os.unlink(sort_dst)
        except BaseException:
            # never leave a partial full-size "sorted" file behind
            _unlink_all([sort_dst])
            raise
        finally:
            _unlink_all(run_paths)
        return total

    records = (
        np.concatenate(all_records)
        if all_records
        else np.empty(0, dtype=RECORD_DTYPE)
    )
    records = sort_batch(
        records,
        bc_len=bc_len,
        umi_len=umi_len,
        index_bits=32 if total <= (1 << 32) else None,
        device=device,
    )
    header.set_sorted()
    with Writer.from_path(ibu_path, header, compression="auto") as w:
        w.write_batch(records)
    return total


def host_stream_stats(batches) -> dict:
    """Count + exact u64 field checksums over an iterator of structured
    record batches, pure numpy: uint64 column sums wrap mod 2^64, which is
    the checksum's arithmetic."""
    from ibu_tpu_torch.ops.u64 import U64_MASK

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
    path: str, engine: str = "auto", device: str | torch.device | None = None
) -> dict:
    """Count + exact field checksums of a whole file, with transport-aware
    engine selection. ``"auto"`` (default) probes the host→device feed rate
    and the native host engine once per process
    (:func:`ibu_tpu_torch.parallel.select.auto_stats_engine`) and routes to
    the faster, announcing the choice on stderr. ``"device"`` streams the
    file to the device (:func:`ibu_tpu_torch.parallel.device.stream_file_stats`);
    ``"native"`` runs the native host engine
    (:func:`ibu_tpu_torch.native.checksum_parallel`); ``"host"`` runs
    :func:`host_file_stats` (numpy). The returned dict names the engine that
    ran under ``"engine"``."""
    with trace.span("ibu.file_stats"):
        _require_plain(path, "stats")
        reader = MmapReader(path)
        n = reader.len()
        trace.count("records", n)
        if engine == "auto":
            from ibu_tpu_torch.parallel.select import auto_stats_engine

            engine = auto_stats_engine(path, n, device=device)
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
            raise ValueError(f"engine must be auto/device/native/host, got {engine!r}")
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
    is first sorted into a temporary file, as in the reference: out of core
    by :func:`ibu_tpu_torch.native.sort_file` where the host library is
    built (so a file larger than the card's memory dedups), else on
    ``device`` (:func:`sort_file_device`). The bytes are the same either
    way, because records with equal (barcode, umi, index) triples are
    identical. Order is verified batch by
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
            if native.available():
                native.sort_file(in_path, tmp)
            else:
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


# ---------------------------------------------------------------------------
# barcode allowlist filtering
# ---------------------------------------------------------------------------


def allowlist_mask(
    bc: np.ndarray, allow: np.ndarray, invert: bool = False
) -> np.ndarray:
    """Membership mask of ``bc`` against a SORTED-unique allowlist
    (vectorized ``searchsorted`` with an end-sentinel clamp): the one
    definition :func:`filter_file` and any sharded filter share, so their
    byte-identical outputs cannot drift apart.
    """
    if len(allow):
        pos = np.searchsorted(allow, bc)
        pos[pos == len(allow)] = 0
        mask = allow[pos] == bc
    else:
        mask = np.zeros(len(bc), dtype=bool)
    return ~mask if invert else mask


def filter_file(
    in_path: str,
    out_path: str,
    barcodes,
    invert: bool = False,
    batch_records: int = 4 * 1024 * 1024,
) -> dict:
    """Keep only records whose barcode is in ``barcodes`` (cell filtering,
    the standard step after a knee-plot barcode selection).

    ``barcodes`` is any integer array-like of packed barcode values (use
    :func:`ibu_tpu_torch.ops.codec.np_pack` / ``encode_seqs`` to build one
    from ACGT strings). Streams with O(batch) memory: membership is a
    vectorized ``searchsorted`` per batch against the sorted allowlist.
    ``invert=True`` keeps records NOT in the list. Record order (and the
    header's sorted flag) is preserved: filtering a sorted file yields a
    sorted file. Returns ``{"records": N, "kept": K, "allowlist": A}``.
    """
    _require_plain(in_path, "filter_file")
    allow = np.unique(np.asarray(list(barcodes), dtype=np.uint64))
    reader = MmapReader(in_path)
    header = reader.header()
    out_header = Header.new(header.bc_len, header.umi_len)
    out_header.flags = header.flags  # sorted flag (and future bits) survive

    n = reader.len()
    kept = 0
    with Writer.from_path(out_path, out_header) as w:
        for start in range(0, n, batch_records):
            batch = np.asarray(
                reader.slice(start, min(start + batch_records, n))
            )
            mask = allowlist_mask(batch["barcode"], allow, invert)
            w.write_batch(batch[mask])
            kept += int(mask.sum())
    return {"records": n, "kept": kept, "allowlist": int(len(allow))}


# ---------------------------------------------------------------------------
# indexed lookup (binary search on the sorted mmap)
# ---------------------------------------------------------------------------


#: floor on the distinct-query count at which lookup switches from
#: page-frugal Python bisects to the one-copy vectorized searchsorted
#: regime (the actual crossover also scales with file size, see
#: :func:`lookup_barcodes`)
LOOKUP_BATCH_MIN = 256


def lookup_barcodes(in_path: str, barcodes) -> np.ndarray:
    """All records for each queried barcode, by binary search on the sorted
    mmap: O(log n) page touches per query plus the hits themselves, so a
    single-cell pull from a multi-GB file reads a few KB.

    Requires the sorted flag (records ordered by (barcode, umi, index));
    raises otherwise. A lying flag yields nonsense ranges, which
    :func:`check_file` and :func:`repair_file` detect and fix.

    Two regimes: for a FEW queries the bisection runs in Python
    deliberately, since about 2·log2(n) single-element reads touch only
    O(log n) pages of the mapping; for an allowlist-sized batch the barcode
    column is materialized once and ONE vectorized ``np.searchsorted`` pair
    finds every range. The crossover scales with the file: the batch path
    pays an O(n) column copy, the bisect path Q·log2(n) interpreted probes,
    so the switch happens at ``max(LOOKUP_BATCH_MIN, n // 20_000)`` distinct
    queries, and a 256-barcode allowlist against a 10^9-record file stays on
    the page-frugal bisect path instead of faulting an 8 GB column in.

    Returns the matching records (ascending barcode, file order within a
    barcode), deduplicating repeated queries.
    """
    _require_plain(in_path, "lookup")
    reader = MmapReader(in_path)
    if not reader.header().sorted():
        raise ValueError(
            f"{in_path}: lookup needs the sorted flag (binary search); "
            "run `python -m ibu_tpu_torch sort` first"
        )
    col = reader.records["barcode"]  # strided memmap view, never copied
    n = len(col)
    if not isinstance(barcodes, np.ndarray):
        barcodes = np.asarray(list(barcodes), dtype=np.uint64)
    queries = np.unique(barcodes.astype(np.uint64, copy=False))

    if len(queries) >= max(LOOKUP_BATCH_MIN, n // 20_000):
        # batch regime: one contiguous copy of the column, two vectorized
        # binary searches, one flat-index gather of all hit ranges
        dense = np.ascontiguousarray(col)
        lo = np.searchsorted(dense, queries, side="left")
        hi = np.searchsorted(dense, queries, side="right")
        lens = (hi - lo).astype(np.int64)
        total = int(lens.sum())
        if total == 0:
            return np.empty(0, dtype=RECORD_DTYPE)
        offsets = np.zeros(len(queries) + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        span = np.repeat(np.arange(len(queries)), lens)
        flat = (
            np.arange(total, dtype=np.int64)
            - offsets[span]
            + lo.astype(np.int64)[span]
        )
        return np.asarray(reader.records[flat])

    def bisect(x: int, right: bool) -> int:
        lo, hi = 0, n
        while lo < hi:
            mid = (lo + hi) // 2
            v = int(col[mid])
            if v < x or (right and v == x):
                lo = mid + 1
            else:
                hi = mid
        return lo

    out = []
    for q in queries:
        lo, hi = bisect(int(q), False), bisect(int(q), True)
        if hi > lo:
            out.append(np.asarray(reader.records[lo:hi]))
    if not out:
        return np.empty(0, dtype=RECORD_DTYPE)
    return np.concatenate(out)


def _batch_uniques(batches):
    for batch in batches:
        yield np.unique(np.asarray(batch)["barcode"], return_counts=True)


def host_stream_histogram(batches) -> dict[int, int]:
    """Barcode → count over an iterator of structured record batches, pure
    host numpy: ``np.unique`` per batch and one final group-sum (the merge
    of :func:`barcode_counts`'s host engine)."""
    from ibu_tpu_torch.ops.stats import group_sum_np

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
    :func:`ibu_tpu_torch.parallel.device.sharded_barcode_histogram`, which
    verifies each batch's order when the header says the file is sorted."""
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
    from ibu_tpu_torch.ops.stats import group_sum_np

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
    from ibu_tpu_torch.ops.stats import pair_molecule_counts
    from ibu_tpu_torch.ops.u64 import records_to_tensor, to_host

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
                    "-m ibu_tpu_torch sort`) or clear the flag (`repair`)"
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
        from ibu_tpu_torch.utils.device import resolve_device

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
    from ibu_tpu_torch.utils.device import resolve_device

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


# ---------------------------------------------------------------------------
# integrity check, concatenation, repair, subsampling
# ---------------------------------------------------------------------------


def check_file(in_path: str, buffer_records: int = 512 * 1024) -> dict:
    """Deep integrity check of an IBU file (plain or gzip/zstd compressed).

    The readers validate lazily: the header on open and record truncation as
    the stream is consumed. ``check_file`` audits a whole file up front: one
    streaming pass that collects *every* problem instead of raising on the
    first, so operators can triage corrupt archives.

    Checks performed:

    * header parses and validates (magic, version, bc/umi length bounds);
    * the record stream ends on a 24-byte boundary (no truncated tail);
    * every barcode/umi fits in ``2*len`` bits (a value outside the
      alphabet capacity cannot come from an ACGT sequence of the declared
      length, a strong signal of header/record mismatch);
    * if the sorted flag is set, records really are lexicographically
      nondecreasing by (barcode, umi, index); a lying flag breaks
      merge/dedup, so it is reported as an error.

    Returns a report dict; ``report["ok"]`` is False iff any *error* was
    found (out-of-range fields are warnings: structurally valid files can
    carry them if written with a different alphabet).
    """
    def _detail(e: IbuError) -> str:
        # CompressionError/IbuIoError messages are the reference-parity
        # "Niffler error"/"I/O error"; surface the wrapped diagnosis for
        # operator triage
        if isinstance(e, (CompressionError, IbuIoError)) and e.inner:
            inner = e.inner
            if isinstance(inner, BaseException):
                return f"{e} ({type(inner).__name__}: {inner})"
            return f"{e} ({inner})"
        return str(e)

    report: dict = {
        "path": in_path,
        "ok": True,
        "errors": [],
        "warnings": [],
        "header": None,
        "records": 0,
        "out_of_range_barcodes": 0,
        "out_of_range_umis": 0,
        "first_order_violation": None,
    }
    try:
        reader = Reader(
            open_decompressed(in_path), buffer_size=buffer_records * 24
        )
    except IbuError as e:
        report["ok"] = False
        report["errors"].append(f"header: {_detail(e)}")
        return report

    header = reader.header()
    report["header"] = header.to_dict()
    bc_cap = None if header.bc_len >= 32 else 1 << (2 * header.bc_len)
    umi_cap = None if header.umi_len >= 32 else 1 << (2 * header.umi_len)
    claim_sorted = header.sorted()
    prev: tuple[int, int, int] | None = None

    with reader:
        while True:
            try:
                batch = reader.read_records()
            except IbuError as e:
                report["ok"] = False
                report["errors"].append(f"stream: {_detail(e)}")
                if isinstance(e, TruncatedRecord):
                    # pos is the offset of the first incomplete record; the
                    # whole records before the tear are intact even though
                    # the refill discarded them.
                    report["records"] = max(
                        report["records"],
                        (e.pos - HEADER_SIZE) // RECORD_SIZE,
                    )
                break
            if batch is None:
                break
            bc, umi, idx = batch["barcode"], batch["umi"], batch["index"]
            if bc_cap is not None:
                report["out_of_range_barcodes"] += int(
                    np.count_nonzero(bc >= bc_cap)
                )
            if umi_cap is not None:
                report["out_of_range_umis"] += int(
                    np.count_nonzero(umi >= umi_cap)
                )
            if claim_sorted and report["first_order_violation"] is None:
                if not _lex_nondecreasing(bc, umi, idx, prev):
                    report["first_order_violation"] = report["records"]
            prev = (int(bc[-1]), int(umi[-1]), int(idx[-1]))
            report["records"] += len(batch)

    if report["first_order_violation"] is not None:
        report["ok"] = False
        report["errors"].append(
            "order: sorted flag is set but records are out of order near "
            f"record {report['first_order_violation']}"
        )
    if report["out_of_range_barcodes"] or report["out_of_range_umis"]:
        report["warnings"].append(
            f"{report['out_of_range_barcodes']} barcodes / "
            f"{report['out_of_range_umis']} umis exceed the "
            f"2*len-bit capacity of bc_len={header.bc_len}, "
            f"umi_len={header.umi_len}"
        )
    return report


def _boundary_records(path: str) -> tuple[tuple, tuple] | None:
    """(first, last) (bc, umi, idx) triples of a file, or None if empty.

    Plain files answer in O(1) via mmap; compressed inputs pay one
    decompression pass (there is no random access into a gzip stream).
    """
    with open(path, "rb") as f:
        magic = f.read(4)
    if sniff_compression(magic) is None:
        r = MmapReader(path)
        if len(r) == 0:
            return None
        first, last = np.asarray(r.slice(0, 1))[0], np.asarray(
            r.slice(len(r) - 1, len(r))
        )[0]
    else:
        first = last = None
        with Reader(open_decompressed(path)) as rd:
            for batch in rd.batches():
                if first is None:
                    first = batch[0]
                last = batch[-1]
        if first is None:
            return None
    as_triple = lambda rec: (
        int(rec["barcode"]), int(rec["umi"]), int(rec["index"])
    )
    return as_triple(first), as_triple(last)


def concat_files(
    in_paths,
    out_path: str,
    buffer_records: int = 512 * 1024,
) -> dict:
    """Concatenate IBU files into one, preserving sortedness when true.

    All inputs must agree on (bc_len, umi_len): mixing dimensions would
    corrupt downstream decoding. The output's sorted flag is set iff every
    input claims sorted AND the file-boundary records are nondecreasing
    (sorted shards concatenated in key order stay sorted: the inverse of
    :func:`split_file`, without the k-way merge cost of
    ``native.merge_files`` when the inputs don't interleave). When the flag
    is set, order is re-verified during the copy; a violation means an
    input's sorted flag lied, and raises (same convention as
    :func:`dedup_file`).

    Inputs may be gzip/zstd compressed (sniffed); ``out_path`` follows
    :meth:`Writer.from_path`'s ``compression="auto"`` extension rule.
    Returns ``{"records": N, "files": k, "sorted": bool}``.
    """
    in_paths = list(in_paths)
    if not in_paths:
        raise ValueError("concat_files requires at least one input")

    headers = []
    for p in in_paths:
        with Reader(open_decompressed(p)) as r:
            headers.append(r.header())
    h0 = headers[0]
    for p, h in zip(in_paths[1:], headers[1:]):
        if (h.bc_len, h.umi_len) != (h0.bc_len, h0.umi_len):
            raise ValueError(
                f"{p}: dimensions (bc_len={h.bc_len}, umi_len={h.umi_len}) "
                f"differ from {in_paths[0]} (bc_len={h0.bc_len}, "
                f"umi_len={h0.umi_len}); refusing to concatenate"
            )

    out_sorted = all(h.sorted() for h in headers)
    if out_sorted:
        prev_last = None
        for p in in_paths:
            bounds = _boundary_records(p)
            if bounds is None:
                continue
            first, last = bounds
            if prev_last is not None and first < prev_last:
                out_sorted = False
                break
            prev_last = last

    out_header = Header.new(h0.bc_len, h0.umi_len)
    if out_sorted:
        out_header.set_sorted()

    total = 0
    prev: tuple[int, int, int] | None = None
    with _removed_on_error(out_path):
        with Writer.from_path(out_path, out_header, compression="auto") as w:
            for p in in_paths:
                with Reader(
                    open_decompressed(p), buffer_size=buffer_records * 24
                ) as rd:
                    for batch in rd.batches():
                        if out_sorted:
                            bc, umi, idx = (
                                batch["barcode"], batch["umi"], batch["index"]
                            )
                            if not _lex_nondecreasing(bc, umi, idx, prev):
                                raise ValueError(
                                    f"{p}: records are not in sorted order "
                                    "despite the sorted flag; re-sort the "
                                    "input or clear its flag"
                                )
                            prev = (int(bc[-1]), int(umi[-1]), int(idx[-1]))
                        w.write_batch(batch)
                        total += len(batch)
    return {"records": total, "files": len(in_paths), "sorted": out_sorted}


def repair_file(
    in_path: str,
    out_path: str,
    bc_len: int | None = None,
    umi_len: int | None = None,
    buffer_records: int = 512 * 1024,
    salvage_chunk_bytes: int = 64 * 1024,
) -> dict:
    """Salvage a damaged IBU file: copy every intact record to ``out_path``
    with a truthful header.

    The readers fail fast on corruption; ``repair_file`` is the recovery
    tool that pairs with :func:`check_file`:

    * a truncated tail is dropped (everything before the tear survives,
      including the whole records the reader's refill would discard);
    * the sorted flag on the output reflects the **observed** order of the
      salvaged records, not the input's claim: a lying flag is corrected in
      both directions (cleared when order is broken, set when an
      unsorted-claimed stream is really sorted, so merge/dedup can use it);
    * an unreadable header (bad magic/version/lengths) is fatal unless
      ``bc_len``/``umi_len`` are forced, in which case the 32 header bytes
      are skipped and the record region re-parsed under the forced
      dimensions.

    The output is always a plain (uncompressed) file: the observed-order
    flag is patched into the header after the copy, which needs a seekable
    sink. Returns ``{"records", "dropped_bytes", "sorted", "actions"}``
    where ``dropped_bytes`` counts the discarded tail in the decompressed
    byte domain. A corrupt compression stream (bad gzip CRC, corrupt zstd
    block) stops the salvage at the last cleanly-decompressed record
    instead of raising. Caveat: zstd decodes at block granularity, so a
    torn zstd frame salvages only up to the last complete block (the tear
    itself is detected); a torn first block salvages zero records and
    raises "nothing to salvage".
    """
    actions: list[str] = []
    forced = bc_len is not None or umi_len is not None
    if forced and (bc_len is None or umi_len is None):
        raise ValueError("force both bc_len and umi_len, or neither")

    # Raw chunked reads with a carry, instead of Reader: the reader's
    # refill discards its whole records when it hits a torn tail, exactly
    # the records a salvage must keep.
    inner = open_decompressed(in_path)
    try:
        head = b""
        while len(head) < HEADER_SIZE:
            chunk = inner.read(HEADER_SIZE - len(head))
            if not chunk:
                break
            head += chunk
        if len(head) < HEADER_SIZE:
            raise IbuError(
                f"{in_path}: only {len(head)} bytes total; nothing to salvage"
            )
        if forced:
            header = Header.new(bc_len, umi_len)
            actions.append(
                f"forced header bc_len={bc_len} umi_len={umi_len} "
                "(original header bytes discarded)"
            )
        else:
            header = Header.from_bytes(head)
            header.validate()  # unrecoverable without forced dims

        out_header = Header.new(header.bc_len, header.umi_len)
        claim = header.sorted()
        observed_sorted = True
        prev: tuple[int, int, int] | None = None
        records = 0
        dropped = 0

        def _consume(batch, w):
            nonlocal observed_sorted, prev, records
            if len(batch) == 0:
                return
            if observed_sorted:
                bc, umi, idx = batch["barcode"], batch["umi"], batch["index"]
                if not _lex_nondecreasing(bc, umi, idx, prev):
                    observed_sorted = False
                prev = (int(bc[-1]), int(umi[-1]), int(idx[-1]))
            w.write_batch(batch)
            records += len(batch)

        # Small read granularity bounds the salvage loss on a torn
        # compression stream: GzipFile.read(n) raises once a request
        # crosses the tear, discarding whatever it had partially
        # decompressed, so big reads would lose everything since the
        # previous request. ``salvage_chunk_bytes`` tunes that loss bound
        # for small files.
        chunk_bytes = max(salvage_chunk_bytes, RECORD_SIZE)
        flush_bytes = buffer_records * RECORD_SIZE
        with Writer.from_path(out_path, out_header) as w:
            pending: list[bytes] = []
            pend_len = 0
            while True:
                try:
                    raw = inner.read(chunk_bytes)
                except (OSError,) + DECOMPRESSION_ERRORS as e:
                    actions.append(
                        f"compression stream died mid-read ({e}); salvage "
                        "stops at the last cleanly-decompressed chunk"
                    )
                    raw = b""
                if raw:
                    pending.append(raw)
                    pend_len += len(raw)
                if pend_len and (not raw or pend_len >= flush_bytes):
                    buf = b"".join(pending)
                    whole = len(buf) - len(buf) % RECORD_SIZE
                    if whole:
                        _consume(records_from_bytes(buf[:whole]), w)
                    pending = [buf[whole:]] if whole != len(buf) else []
                    pend_len = len(buf) - whole
                if not raw:
                    if pend_len:
                        dropped = pend_len
                        actions.append(
                            f"dropped {dropped} trailing bytes "
                            "(partial record)"
                        )
                    break
    finally:
        inner.close()

    if observed_sorted and records > 0:
        out_header.set_sorted()
        if not claim and not forced:
            actions.append("set sorted flag (records are in order; "
                           "input did not claim it)")
    if not observed_sorted and claim:
        actions.append("cleared lying sorted flag (records out of order)")
    # patch the observed-order flag into the already-written plain header
    with open(out_path, "r+b") as f:
        f.seek(16)
        f.write(struct.pack("<Q", out_header.flags))

    return {
        "records": records,
        "dropped_bytes": dropped,
        "sorted": bool(out_header.sorted()),
        "actions": actions,
    }


def subsample_file(
    in_path: str,
    out_path: str,
    fraction: float | None = None,
    n: int | None = None,
    seed: int = 0,
    batch_records: int = 4 * 1024 * 1024,
) -> dict:
    """Exact seeded downsampling: keep a uniform random subset of records,
    without replacement, in one streaming pass.

    Give exactly one of ``fraction`` (0 < f ≤ 1; sample size is
    ``round(f * N)``) or ``n`` (absolute count ≤ N). File order is
    preserved, so a sorted input stays sorted and the flag carries over:
    downsampled files feed merge/dedup unchanged.

    Exactness without materializing indices: per batch, the number drawn is
    a hypergeometric split of the remaining quota over the remaining records
    (the batch is the "marked" population), then that many in-batch
    positions are chosen without replacement. The composition is
    distributionally identical to ``choice(N, n)`` but needs O(batch)
    memory.

    Plain files stream off the mmap; gzip/zstd inputs (sniffed, like every
    reader) pay one extra decompression pass to learn the record count: the
    hypergeometric split needs N up front, and compressed streams have no
    random access. The batch sequence differs between the two paths, so the
    sampled set for a given seed is path-dependent (but equally exact).

    Returns ``{"records": N, "sampled": n, "seed": seed}``.
    """
    if (fraction is None) == (n is None):
        raise ValueError("give exactly one of fraction or n")

    with open(in_path, "rb") as f:
        compressed = sniff_compression(f.read(4)) is not None
    if compressed:
        # counting pass: no random access into a compressed stream
        with Reader(open_decompressed(in_path)) as r:
            header = r.header()
            total = sum(len(b) for b in r.batches())
    else:
        reader = MmapReader(in_path)
        header = reader.header()
        total = reader.len()

    if fraction is not None:
        if not 0.0 < fraction <= 1.0:
            raise ValueError(f"fraction must be in (0, 1], got {fraction}")
        n = round(fraction * total)
    if not 0 <= n <= total:
        raise ValueError(f"n={n} out of range for a {total}-record file")

    def batches():
        if compressed:
            with Reader(
                open_decompressed(in_path),
                buffer_size=batch_records * 24,
            ) as r:
                yield from r.batches()
        else:
            for start in range(0, total, batch_records):
                end = min(start + batch_records, total)
                yield np.asarray(reader.slice(start, end))

    rng = np.random.default_rng(seed)
    out_header = Header.new(header.bc_len, header.umi_len)
    out_header.flags = header.flags  # order preserved → flag stays truthful

    remaining_records = total
    remaining_quota = n
    written = 0
    with Writer.from_path(out_path, out_header) as w:
        for batch in batches():
            b = len(batch)
            remaining_records -= b
            take = int(rng.hypergeometric(b, remaining_records, remaining_quota)) \
                if remaining_records else remaining_quota
            remaining_quota -= take
            if take == 0:
                continue
            if take == b:
                w.write_batch(batch)
            else:
                keep = np.sort(rng.choice(b, take, replace=False))
                w.write_batch(batch[keep])
            written += take
    assert written == n and remaining_quota == 0
    return {"records": total, "sampled": written, "seed": seed}
