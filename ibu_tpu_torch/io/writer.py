"""Buffered IBU writer.

A copy of :mod:`ibu_tpu.io.writer` (without stdout, the in-memory shard
merge and the native threaded write, so every byte goes through the sink's
own ``write``), with the reference
writer's behaviour (``src/io/writer.rs:82-523``):

* the header is written at construction and, as in the reference, not
  validated: only readers validate;
* a 48K-record (1,179,648-byte) internal buffer (``writer.rs:10``);
  batches larger than the buffer bypass it (``writer.rs:321-351``);
* close, ``__exit__`` and garbage collection finish the stream
  (``writer.rs:519-523``).
"""

from __future__ import annotations

import io
import sys
from typing import BinaryIO

import numpy as np

from ibu_tpu_torch.constructs.header import Header
from ibu_tpu_torch.constructs.record import RECORD_DTYPE, RECORD_SIZE, Record
from ibu_tpu_torch.errors import IbuIoError
from ibu_tpu_torch.io.compression import open_compressed

#: 48K records, same as the reference (``writer.rs:10``).
DEFAULT_BUFFER_RECORDS: int = 48 * 1024
DEFAULT_BUFFER_SIZE: int = DEFAULT_BUFFER_RECORDS * RECORD_SIZE


class Writer:
    """Buffered writer of IBU record streams.

    >>> import io
    >>> from ibu_tpu_torch import Header, Writer, make_records
    >>> w = Writer.new(io.BytesIO(), Header.new(16, 12))
    >>> w.write_batch(make_records([4], [5], [6]))
    >>> w.finish()
    >>> (w.records_written, len(w.inner.getvalue()))
    (1, 56)
    """

    def __init__(self, inner: BinaryIO, header: Header | None,
                 buffer_size: int = DEFAULT_BUFFER_SIZE):
        self._inner = inner
        # at least one record must fit or write_record cannot make progress
        self._buffer = bytearray(max(buffer_size, RECORD_SIZE))
        self._pos = 0
        self._records_written = 0
        self._finished = False
        if header is not None:
            self._write_all(header.as_bytes())

    @classmethod
    def new(cls, inner: BinaryIO, header: Header) -> "Writer":
        """Writer that emits ``header`` immediately (ref ``writer.rs:129-143``)."""
        return cls(inner, header)

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
            return cls(f, header)
        return cls(open_compressed(path, compression, level, threads), header)

    @property
    def records_written(self) -> int:
        """Total records accepted so far (ref ``writer.rs:207-209``)."""
        return self._records_written

    @property
    def inner(self) -> BinaryIO:
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

    def _write_slice(self, data: memoryview, num_records: int) -> None:
        if len(data) > len(self._buffer):
            # direct path: skip the intermediate copy (ref writer.rs:325-331)
            self._flush_buffer()
            self._write_all(data)
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
