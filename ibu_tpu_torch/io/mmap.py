"""Memory-mapped IBU reader.

A copy of :class:`ibu_tpu.io.mmap.MmapReader` and its streaming defaults,
with the reference mmap reader's behaviour (``src/io/mmap.rs:99-284``): the
header is validated at construction, a ragged record region raises
:class:`InvalidMapSize`, and :meth:`MmapReader.slice` is a zero-copy,
bounds-checked view with the reference's error payloads. The map is a
``np.memmap`` of :data:`RECORD_DTYPE`. (The host thread engine,
``process_parallel``, is not part of the port yet.)
"""

from __future__ import annotations

import os

import numpy as np

from ibu_tpu_torch.constructs.header import HEADER_SIZE, Header
from ibu_tpu_torch.constructs.record import RECORD_DTYPE, RECORD_SIZE
from ibu_tpu_torch.errors import IbuIoError, InvalidIndex, InvalidMapSize

#: Records per processing batch, ~24 MiB (ref ``mmap.rs:284``).
BATCH_SIZE: int = 1024 * 1024

#: Default host→device batch of the streaming engines, in records
#: (override with ``IBU_STREAM_BATCH_RECORDS``).
STREAM_BATCH_RECORDS: int = int(os.environ.get("IBU_STREAM_BATCH_RECORDS", BATCH_SIZE))

#: Default number of batches in flight ahead of the consumer
#: (override with ``IBU_STREAM_PREFETCH``).
STREAM_PREFETCH: int = int(os.environ.get("IBU_STREAM_PREFETCH", 4))


class MmapReader:
    """Zero-copy random-access reader over a memory-mapped IBU file.

    ``slice(start, end)`` raises ``InvalidIndex(idx=end, max=len)`` when
    ``start >= len``, ``end > len`` or ``end <= start``
    (``mmap.rs:253-270``).
    """

    def __init__(self, path: str):
        try:
            size = os.path.getsize(path)
            with open(path, "rb") as f:
                header_bytes = f.read(HEADER_SIZE)
            if len(header_bytes) < HEADER_SIZE:
                raise IbuIoError(f"file too small for IBU header: {size} bytes")
            self._header = Header.from_bytes(header_bytes)
            self._header.validate()
            data_size = size - HEADER_SIZE
            if data_size % RECORD_SIZE != 0:
                raise InvalidMapSize()
            self._len = data_size // RECORD_SIZE
            if self._len > 0:
                self._map = np.memmap(path, dtype=RECORD_DTYPE, mode="r", offset=HEADER_SIZE,
                                      shape=(self._len,))
            else:
                self._map = np.empty(0, dtype=RECORD_DTYPE)
        except OSError as e:
            raise IbuIoError(e) from e
        self._path = path

    def __len__(self) -> int:
        return self._len

    def len(self) -> int:
        """Record count, derived from file size (ref ``mmap.rs:178-180``)."""
        return self._len

    def header(self) -> Header:
        """A copy of the validated header (ref ``mmap.rs:201-203``)."""
        return Header.from_bytes(self._header.as_bytes())

    @property
    def path(self) -> str:
        return self._path

    @property
    def records(self) -> np.ndarray:
        """The whole record region as a zero-copy structured view."""
        return self._map

    def slice(self, start: int, end: int) -> np.ndarray:
        """Zero-copy view of records ``[start, end)`` (``mmap.rs:253-270``)."""
        if start >= self._len or end > self._len or end <= start:
            raise InvalidIndex(idx=end, max=self._len)
        return self._map[start:end]

    def barcodes(self) -> np.ndarray:
        """``uint64`` barcode column (zero-copy strided view)."""
        return self._map["barcode"]

    def umis(self) -> np.ndarray:
        """``uint64`` UMI column (zero-copy strided view)."""
        return self._map["umi"]

    def indices(self) -> np.ndarray:
        """``uint64`` index column (zero-copy strided view)."""
        return self._map["index"]
