"""Buffered IBU writer.

A copy of :mod:`ibu_tpu.io.writer`, with the reference writer's behaviour
(``src/io/writer.rs:82-523``):

* the header is written at construction and, as in the reference, not
  validated: only readers validate;
* a 48K-record (1,179,648-byte) internal buffer (``writer.rs:10``);
  batches larger than the buffer bypass it (``writer.rs:321-351``), through
  the native threaded ``pwrite`` from 8 MB on a plain disk file;
* ``new_headless`` omits the header for shard writers
  (``writer.rs:169-179``), and ``ingest`` moves another in-memory writer's
  records into this one and clears it (``writer.rs:477-482``);
* close, ``__exit__`` and garbage collection finish the stream
  (``writer.rs:519-523``).
"""

from __future__ import annotations

import io
import sys
from typing import BinaryIO, Iterable, Iterator

import numpy as np

from ibu_tpu_torch.constructs.header import Header
from ibu_tpu_torch.constructs.record import RECORD_DTYPE, RECORD_SIZE, Record
from ibu_tpu_torch.errors import IbuIoError

#: 48K records, same as the reference (``writer.rs:10``).
DEFAULT_BUFFER_RECORDS: int = 48 * 1024
DEFAULT_BUFFER_SIZE: int = DEFAULT_BUFFER_RECORDS * RECORD_SIZE


class Writer:
    """Buffered writer of IBU record streams.

    >>> import io
    >>> from ibu_tpu_torch import Header, Record, Writer, make_records
    >>> w = Writer.new(io.BytesIO(), Header.new(16, 12))
    >>> w.write_batch(make_records([4], [5], [6]))
    >>> w.finish()
    >>> (w.records_written, len(w.inner.getvalue()))
    (1, 56)

    In memory, one record at a time, and a headless shard spliced in:

    >>> w = Writer.in_memory(Header.new(16, 12))
    >>> w.write_record(Record(barcode=1, umi=2, index=3))
    >>> w.write_batch(make_records([4], [5], [6]))
    >>> w.records_written
    2
    >>> shard = Writer.in_memory()  # headless: no 32-byte header
    >>> shard.write_record(Record(barcode=7, umi=8, index=9))
    >>> w.ingest(shard)             # splice shard bytes, clear the shard
    >>> (w.records_written, len(shard.inner.getvalue()))
    (3, 0)
    >>> w.finish()
    >>> len(w.inner.getvalue())  # 32-byte header + 3 * 24-byte records
    104
    """

    def __init__(self, inner: BinaryIO, header: Header | None,
                 buffer_size: int = DEFAULT_BUFFER_SIZE):
        self._inner = inner
        # set by from_path for a plain disk file only: large batches may then
        # go through the native threaded pwrite (never for a compressed,
        # stdout or in-memory sink, whose bytes must pass through the object)
        self._native_write = False
        # at least one record must fit or write_record cannot make progress
        self._buffer = bytearray(max(buffer_size, RECORD_SIZE))
        self._pos = 0
        self._records_written = 0
        self._finished = False
        self._wrote_header = header is not None
        if header is not None:
            self._write_all(header.as_bytes())

    @classmethod
    def new(cls, inner: BinaryIO, header: Header) -> "Writer":
        """Writer that emits ``header`` immediately (ref ``writer.rs:129-143``)."""
        return cls(inner, header)

    @classmethod
    def new_headless(cls, inner: BinaryIO) -> "Writer":
        """Writer that skips the header: a shard writer whose records are
        later moved into another by :meth:`ingest` (ref
        ``writer.rs:169-179``)."""
        return cls(inner, None)

    @classmethod
    def from_path(cls, path: str, header: Header, compression: str | None = None,
                  level: int | None = None, threads: int = -1) -> "Writer":
        """Open ``path`` and write ``header``: a plain file by default, as in
        the reference (``writer.rs:556-559``); ``compression`` ``"gzip"``,
        ``"zstd"`` or ``"auto"`` (by extension) compresses it
        (:func:`ibu_tpu_torch.io.compression.open_compressed`)."""
        if compression is None:
            try:
                f: BinaryIO = open(path, "wb")
            except OSError as e:
                raise IbuIoError(e) from e
            w = cls(f, header)
            w._native_write = True
            return w
        from ibu_tpu_torch.io.compression import open_compressed

        return cls(open_compressed(path, compression, level, threads), header)

    @classmethod
    def from_stdout(cls, header: Header) -> "Writer":
        """Write to standard output (ref ``writer.rs:587-589``)."""
        return cls(sys.stdout.buffer, header)

    @classmethod
    def from_optional_path(
        cls, path: str | None, header: Header, compression: str | None = None,
        level: int | None = None,
    ) -> "Writer":
        """``path=None`` → stdout (ref ``writer.rs:618-626``)."""
        if path is None:
            return cls.from_stdout(header)
        return cls.from_path(path, header, compression, level)

    @classmethod
    def in_memory(cls, header: Header | None = None) -> "Writer":
        """Writer over an in-memory buffer (the reference's
        ``Writer<Vec<u8>>``); headless unless given a header."""
        return cls(io.BytesIO(), header)

    @property
    def records_written(self) -> int:
        """Total records accepted so far (ref ``writer.rs:207-209``)."""
        return self._records_written

    @property
    def inner(self) -> BinaryIO:
        return self._inner

    def into_inner(self) -> BinaryIO:
        """Detach and return the sink without flushing: call :meth:`finish`
        first (ref ``writer.rs:507-511``)."""
        self._finished = True
        return self._inner

    def _write_all(self, data: bytes | memoryview) -> None:
        try:
            mv = memoryview(data)
            while len(mv) > 0:
                n = self._inner.write(mv)
                if n is None:  # non-blocking sink; BinaryIO contract violation
                    raise IbuIoError("sink returned None from write")
                mv = mv[n:]
        except OSError as e:
            raise IbuIoError(e) from e

    def _flush_buffer(self) -> None:
        if self._pos > 0:
            self._write_all(memoryview(self._buffer)[: self._pos])
            self._pos = 0

    def write_record(self, record: Record) -> None:
        """Append one record (ref ``writer.rs:260-273``)."""
        if self._pos + RECORD_SIZE > len(self._buffer):
            self._flush_buffer()
        self._buffer[self._pos : self._pos + RECORD_SIZE] = record.as_bytes()
        self._pos += RECORD_SIZE
        self._records_written += 1

    def write_batch(self, records) -> None:
        """Append a structured array of :data:`RECORD_DTYPE` (written as one
        view of its bytes) or any iterable of :class:`Record`."""
        if isinstance(records, np.ndarray):
            if records.dtype != RECORD_DTYPE:
                raise ValueError(f"write_batch expects dtype {RECORD_DTYPE}, got {records.dtype}")
            arr = np.ascontiguousarray(records)
            self._write_slice(memoryview(arr).cast("B"), len(arr))
        else:
            records = list(records)
            data = b"".join(r.as_bytes() for r in records)
            self._write_slice(memoryview(data), len(records))

    #: below this many bytes a threaded pwrite is not worth starting
    _NATIVE_WRITE_MIN_BYTES = 8 << 20

    def _write_direct(self, data: memoryview) -> None:
        """A batch larger than the buffer: the native ``pwrite`` for a plain
        disk file from 8 MB (page-cache writes are memcpy-bound), the sink's
        own ``write`` otherwise."""
        if self._native_write and len(data) >= self._NATIVE_WRITE_MIN_BYTES:
            from ibu_tpu_torch import native

            if native.available():
                try:
                    self._inner.flush()
                    off = self._inner.tell()
                    fd = self._inner.fileno()
                except OSError:
                    # a path that cannot seek (a FIFO, /dev/stdout): stream it
                    self._write_all(data)
                    return
                try:
                    # one thread: page-cache writes serialise on the page
                    # allocator, so more threads buy nothing, unlike reads
                    native.pwrite_parallel(fd, data, off, nthreads=1)
                    self._inner.seek(off + len(data))
                except OSError as e:
                    raise IbuIoError(e) from e
                return
        self._write_all(data)

    def _write_slice(self, data: memoryview, num_records: int) -> None:
        if len(data) > len(self._buffer):
            # direct path: skip the intermediate copy (ref writer.rs:325-331)
            self._flush_buffer()
            self._write_direct(data)
            self._records_written += num_records
            return
        remaining = data
        while len(remaining) > 0:
            n = min(len(remaining), len(self._buffer) - self._pos)
            self._buffer[self._pos : self._pos + n] = remaining[:n]
            self._pos += n
            remaining = remaining[n:]
            if self._pos >= len(self._buffer):
                self._flush_buffer()
        self._records_written += num_records

    def write_iter(self, records: Iterable[Record] | Iterator[Record]) -> None:
        """Write every record of an iterator (ref ``writer.rs:388-396``)."""
        for record in records:
            self.write_record(record)

    def ingest(self, other: "Writer") -> None:
        """Move another in-memory writer's records into this one, then clear
        it (ref ``writer.rs:477-482``). ``other`` must be in memory and
        headless: a header among the records would corrupt the file."""
        if not isinstance(other._inner, io.BytesIO):
            raise TypeError("ingest requires the source writer to be in-memory")
        if other._wrote_header:
            raise ValueError(
                "ingest source must be headless (Writer.new_headless / "
                "Writer.in_memory()); its header bytes would corrupt the "
                "record stream"
            )
        other._flush_buffer()
        data = other._inner.getvalue()
        self._write_slice(memoryview(data), len(data) // RECORD_SIZE)
        other._inner.seek(0)
        other._inner.truncate(0)

    def finish(self) -> None:
        """Flush the internal buffer and the sink (ref ``writer.rs:429-433``)."""
        self._flush_buffer()
        try:
            self._inner.flush()
        except OSError as e:
            raise IbuIoError(e) from e
        self._finished = True

    def close(self) -> None:
        """Finish, then close the sink; in-memory and stdout sinks stay open
        (the reference's ``Drop`` only flushes, ``writer.rs:519-523``)."""
        self.finish()
        if self._inner is not getattr(sys.stdout, "buffer", None) and not isinstance(
            self._inner, io.BytesIO
        ):
            self._inner.close()

    def __enter__(self) -> "Writer":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
        else:  # best effort, as the reference's Drop (writer.rs:519-523)
            try:
                self.close()
            except Exception:
                pass

    def __del__(self):
        if not self._finished:
            try:
                self.finish()
            except Exception:
                pass
