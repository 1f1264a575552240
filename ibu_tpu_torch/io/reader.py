"""Streaming IBU reader and bulk loader.

A copy of :mod:`ibu_tpu.io.reader` (without stdin, ``Reader.clone`` and the
native threaded read), with the reference reader's behaviour
(``src/io/reader.rs:90-535``):

* the header is read and validated at construction (``reader.rs:152-176``);
* batched refills of a 48K-record buffer, looping the underlying ``read``
  until full or EOF (``reader.rs:218-242``);
* a refill whose byte count is not a multiple of 24 raises
  :class:`TruncatedRecord` with ``pos = bytes_read + complete_bytes``
  (``reader.rs:232-237``); a torn gzip/zstd stream raises
  :class:`CompressionError`;
* ``bytes_read`` starts at 32 (the header) and tracks the stream position;
* ``from_path`` transparently decompresses gzip/zstd (``reader.rs:345-357``);
* :func:`load_to_vec` bulk-loads a plain file, raising
  :class:`InvalidMapSize` when the record region is ragged
  (``reader.rs:510-535``).

:meth:`Reader.batches` yields structured record arrays, the form the device
stream and the histogram engines take.
"""

from __future__ import annotations

import os
from typing import BinaryIO, Iterator

import numpy as np

from ibu_tpu_torch.constructs.header import HEADER_SIZE, Header
from ibu_tpu_torch.constructs.record import RECORD_DTYPE, RECORD_SIZE, Record
from ibu_tpu_torch.errors import CompressionError, IbuIoError, InvalidMapSize, TruncatedRecord
from ibu_tpu_torch.io.compression import DECOMPRESSION_ERRORS, open_decompressed

#: 48K records per refill, same as the reference (``reader.rs:14``).
DEFAULT_BUFFER_RECORDS: int = 48 * 1024
DEFAULT_BUFFER_SIZE: int = DEFAULT_BUFFER_RECORDS * RECORD_SIZE


class Reader:
    """Buffered streaming reader of IBU record streams.

    >>> import io
    >>> from ibu_tpu_torch import Header, Reader, Writer, make_records
    >>> buf = io.BytesIO()
    >>> w = Writer.new(buf, Header.new(16, 12))
    >>> w.write_batch(make_records([5, 8], [6, 9], [7, 10]))
    >>> w.finish()
    >>> _ = buf.seek(0)
    >>> [int(u) for u in next(Reader(buf).batches())["umi"]]
    [6, 9]
    """

    def __init__(self, inner: BinaryIO, buffer_size: int = DEFAULT_BUFFER_SIZE):
        self._inner = inner
        self._header = Header.from_bytes(self._read_exact(HEADER_SIZE))
        self._header.validate()
        # round down to whole records (min 1): a ragged buffer that fills
        # completely would otherwise raise a spurious TruncatedRecord
        buffer_size = max(buffer_size - buffer_size % RECORD_SIZE, RECORD_SIZE)
        self._buffer = bytearray(buffer_size)
        self._pos = 0  # record position within the buffer
        self._cap = 0  # valid records in the buffer
        self._bytes_read = HEADER_SIZE
        self._eof = False

    @classmethod
    def from_path(cls, path: str) -> "Reader":
        """Open ``path``, transparently decompressing gzip/zstd
        (ref ``reader.rs:345-357``)."""
        return cls(open_decompressed(path))

    def header(self) -> Header:
        """A copy of the validated file header (ref ``reader.rs:274-276``)."""
        return Header.from_bytes(self._header.as_bytes())

    @property
    def bytes_read(self) -> int:
        """Total bytes consumed from the stream, including the header."""
        return self._bytes_read

    def _read_exact(self, n: int) -> bytes:
        chunks = []
        got = 0
        try:
            while got < n:
                chunk = self._inner.read(n - got)
                if not chunk:
                    raise IbuIoError(f"unexpected end of stream: wanted {n} bytes, got {got}")
                chunks.append(chunk)
                got += len(chunk)
        # DECOMPRESSION_ERRORS first: gzip.BadGzipFile subclasses OSError
        except DECOMPRESSION_ERRORS as e:
            raise CompressionError(e) from e
        except OSError as e:
            raise IbuIoError(e) from e
        return b"".join(chunks)

    def read_batch(self) -> bool:
        """Refill the internal buffer (ref ``reader.rs:218-242``): ``True``
        if any data was read, ``False`` at EOF. Raises
        :class:`TruncatedRecord` if the stream ended mid-record."""
        read = 0
        view = memoryview(self._buffer)
        try:
            while read < len(self._buffer):
                chunk = self._inner.read(len(self._buffer) - read)
                if not chunk:
                    break
                view[read : read + len(chunk)] = chunk
                read += len(chunk)
        # DECOMPRESSION_ERRORS first: gzip.BadGzipFile subclasses OSError
        except DECOMPRESSION_ERRORS as e:
            raise CompressionError(e) from e
        except OSError as e:
            raise IbuIoError(e) from e
        if read % RECORD_SIZE != 0:
            raise TruncatedRecord(pos=self._bytes_read + read - read % RECORD_SIZE)
        self._pos = 0
        self._cap = read // RECORD_SIZE
        self._bytes_read += read
        return read > 0

    def read_records(self) -> np.ndarray | None:
        """The next refill as a structured record array, or ``None`` at EOF.
        Consumes any records not yet taken by the iterator."""
        if self._pos >= self._cap:
            if self._eof or not self.read_batch():
                self._eof = True
                return None
        start, end = self._pos * RECORD_SIZE, self._cap * RECORD_SIZE
        out = np.frombuffer(memoryview(self._buffer)[start:end], dtype=RECORD_DTYPE).copy()
        self._pos = self._cap
        return out

    def batches(self) -> Iterator[np.ndarray]:
        """Iterate over the stream as structured record arrays."""
        while True:
            batch = self.read_records()
            if batch is None:
                return
            yield batch

    def __iter__(self) -> Iterator[Record]:
        return self

    def __next__(self) -> Record:
        """One record at a time (ref ``reader.rs:279-306``)."""
        if self._eof:
            raise StopIteration
        if self._pos >= self._cap:
            if not self.read_batch():
                self._eof = True
                raise StopIteration
        lpos = self._pos * RECORD_SIZE
        record = Record.from_bytes(bytes(self._buffer[lpos : lpos + RECORD_SIZE]))
        self._pos += 1
        return record

    def close(self) -> None:
        self._inner.close()

    def __enter__(self) -> "Reader":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


def load_to_vec(path: str) -> tuple[Header, np.ndarray]:
    """Bulk-load an uncompressed IBU file (ref ``reader.rs:510-535``):
    validate the header, check ``(filesize - 32) % 24 == 0`` (else
    :class:`InvalidMapSize`) and read the record region in one call. Like
    the reference, this path does not sniff compression."""
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            header_bytes = f.read(HEADER_SIZE)
            if len(header_bytes) < HEADER_SIZE:
                raise IbuIoError(
                    f"unexpected end of file: wanted {HEADER_SIZE} bytes, "
                    f"got {len(header_bytes)}"
                )
            header = Header.from_bytes(header_bytes)
            header.validate()
            data_size = size - HEADER_SIZE
            if data_size % RECORD_SIZE != 0:
                raise InvalidMapSize()
            n = data_size // RECORD_SIZE
            records = np.fromfile(f, dtype=RECORD_DTYPE, count=n)
            if len(records) != n:
                raise IbuIoError(f"short read: wanted {n} records, got {len(records)}")
            return header, records
    except OSError as e:
        raise IbuIoError(e) from e
