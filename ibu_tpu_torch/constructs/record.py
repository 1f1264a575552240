"""The 24-byte IBU record and structured record arrays.

A copy of the parts of :mod:`ibu_tpu.constructs.record` that the port uses.
The wire layout is byte-exact with the reference
(``src/constructs/record.rs:58-66``): three little-endian ``u64`` fields
``barcode``, ``umi``, ``index``. On the host a batch is a numpy structured
array of :data:`RECORD_DTYPE`; on the device it is the ``(N, 3)`` int64 view
of the same bytes (:mod:`ibu_tpu_torch.ops.u64`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

RECORD_SIZE: int = 24  # bytes on the wire (ref record.rs:3)

#: Canonical host dtype; ``itemsize == 24`` and matches the wire byte-for-byte.
RECORD_DTYPE = np.dtype([("barcode", "<u8"), ("umi", "<u8"), ("index", "<u8")])
assert RECORD_DTYPE.itemsize == RECORD_SIZE

_U64_MASK = 0xFFFFFFFFFFFFFFFF


@dataclass(frozen=True)
class Record:
    """One IBU record (ref ``record.rs:58-66``), ordered barcode → umi →
    index (ref ``record.rs:29-32``).

    >>> r = Record(barcode=0x1234, umi=0x5678, index=42)
    >>> Record.from_bytes(r.as_bytes()) == r
    True
    >>> Record(1, 9, 9) < Record(2, 0, 0)
    True
    """

    barcode: int = 0
    umi: int = 0
    index: int = 0

    def as_bytes(self) -> bytes:
        """24-byte little-endian wire form (ref ``record.rs:87-110``)."""
        return (
            (self.barcode & _U64_MASK).to_bytes(8, "little")
            + (self.umi & _U64_MASK).to_bytes(8, "little")
            + (self.index & _U64_MASK).to_bytes(8, "little")
        )

    @classmethod
    def from_bytes(cls, data: bytes) -> "Record":
        if len(data) != RECORD_SIZE:
            raise ValueError(
                f"Record.from_bytes requires exactly {RECORD_SIZE} bytes, got {len(data)}"
            )
        return cls(
            barcode=int.from_bytes(data[0:8], "little"),
            umi=int.from_bytes(data[8:16], "little"),
            index=int.from_bytes(data[16:24], "little"),
        )

    # serde parity (reference's optional serde feature, Cargo.toml:22-25)
    def to_dict(self) -> dict:
        return {"barcode": self.barcode, "umi": self.umi, "index": self.index}

    @classmethod
    def from_dict(cls, d: dict) -> "Record":
        return cls(barcode=d["barcode"], umi=d["umi"], index=d["index"])

    def _key(self):
        return (self.barcode, self.umi, self.index)

    def __lt__(self, other: "Record") -> bool:
        return self._key() < other._key()

    def __le__(self, other: "Record") -> bool:
        return self._key() <= other._key()

    def __gt__(self, other: "Record") -> bool:
        return self._key() > other._key()

    def __ge__(self, other: "Record") -> bool:
        return self._key() >= other._key()


def empty_records(n: int) -> np.ndarray:
    """Zeroed structured record array of length ``n``."""
    return np.zeros(n, dtype=RECORD_DTYPE)


def make_records(barcode: np.ndarray, umi: np.ndarray, index: np.ndarray) -> np.ndarray:
    """Assemble a structured record array from three ``uint64`` columns."""
    out = np.empty(len(barcode), dtype=RECORD_DTYPE)
    out["barcode"] = barcode
    out["umi"] = umi
    out["index"] = index
    return out


def records_to_bytes(records: np.ndarray) -> bytes:
    """Serialize a record batch to wire bytes."""
    if records.dtype != RECORD_DTYPE:
        raise ValueError(f"expected dtype {RECORD_DTYPE}, got {records.dtype}")
    return np.ascontiguousarray(records).tobytes()


def records_from_bytes(data: bytes | bytearray | memoryview) -> np.ndarray:
    """Parse wire bytes into a structured record array (copies once)."""
    buf = memoryview(data)
    if len(buf) % RECORD_SIZE != 0:
        raise ValueError(
            f"byte length {len(buf)} is not a multiple of RECORD_SIZE={RECORD_SIZE}"
        )
    return np.frombuffer(buf, dtype=RECORD_DTYPE).copy()


def sort_records(records: np.ndarray) -> np.ndarray:
    """Sort by (barcode, umi, index) (ref ``record.rs:29-32``): ``np.sort``
    on the structured dtype compares the fields in declaration order, which
    is the reference's derived ``Ord``."""
    return np.sort(records, order=("barcode", "umi", "index"))
