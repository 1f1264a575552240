"""The 32-byte IBU file header.

A copy of :mod:`ibu_tpu.constructs.header`. Byte-exact with the reference
layout (``src/constructs/header.rs:48-61``):

    | offset | size | field    |
    |--------|------|----------|
    | 0      | 4    | magic    |  0x21554249 ("IBU!" little-endian)
    | 4      | 4    | version  |  currently 2
    | 8      | 4    | bc_len   |  barcode length in bases (1-32)
    | 12     | 4    | umi_len  |  UMI length in bases (1-32)
    | 16     | 8    | flags    |  bit 0 = sorted, rest reserved
    | 24     | 8    | reserved |  zeroed

All integers little-endian. Validation checks magic, then version, then
bc_len, then umi_len (``header.rs:167-187``).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from ibu_tpu_torch.errors import (
    InvalidBarcodeLength,
    InvalidMagicNumber,
    InvalidUmiLength,
    InvalidVersion,
)

MAGIC: int = 0x21554249  # b"IBU!" read as little-endian u32 (ref header.rs:5)
VERSION: int = 2  # ref header.rs:6
HEADER_SIZE: int = 32  # ref header.rs:7

_HEADER_STRUCT = struct.Struct("<IIIIQ8s")
assert _HEADER_STRUCT.size == HEADER_SIZE

_FLAG_SORTED: int = 1  # bit 0 (ref header.rs:111-132)


@dataclass
class Header:
    """IBU file header (ref ``header.rs:44-61``).

    Construct with :meth:`new` for a valid header, or directly for tests that
    need invalid field values.

    >>> header = Header.new(16, 12)
    >>> header.set_sorted()
    >>> (header.bc_len, header.umi_len, header.sorted())
    (16, 12, True)
    >>> Header.from_bytes(header.as_bytes()) == header
    True
    """

    magic: int = MAGIC
    version: int = VERSION
    bc_len: int = 0
    umi_len: int = 0
    flags: int = 0
    reserved: bytes = field(default=b"\x00" * 8)

    @classmethod
    def new(cls, bc_len: int, umi_len: int) -> "Header":
        """Current magic and version, unsorted, zero reserved
        (ref ``header.rs:84-93``). Does not validate: only readers do."""
        return cls(magic=MAGIC, version=VERSION, bc_len=bc_len, umi_len=umi_len)

    def set_sorted(self) -> None:
        """Mark records as sorted by (barcode, umi, index) (ref ``header.rs:111-113``)."""
        self.flags |= _FLAG_SORTED

    def clear_sorted(self) -> None:
        """Clear the sorted flag (bit 0)."""
        self.flags &= ~_FLAG_SORTED & 0xFFFFFFFFFFFFFFFF

    def sorted(self) -> bool:
        """Whether the sorted flag (bit 0) is set (ref ``header.rs:130-132``)."""
        return (self.flags & _FLAG_SORTED) != 0

    def validate(self) -> None:
        """Raise if any field is invalid, in the reference's order: magic,
        version, bc_len, umi_len (ref ``header.rs:167-187``)."""
        if self.magic != MAGIC:
            raise InvalidMagicNumber(expected=MAGIC, actual=self.magic)
        if self.version != VERSION:
            raise InvalidVersion(expected=VERSION, actual=self.version)
        if self.bc_len == 0 or self.bc_len > 32:
            raise InvalidBarcodeLength(self.bc_len)
        if self.umi_len == 0 or self.umi_len > 32:
            raise InvalidUmiLength(self.umi_len)

    def as_bytes(self) -> bytes:
        """Serialize to the 32-byte wire form (ref ``header.rs:203-205``)."""
        reserved = bytes(self.reserved)[:8].ljust(8, b"\x00")
        return _HEADER_STRUCT.pack(
            self.magic & 0xFFFFFFFF,
            self.version & 0xFFFFFFFF,
            self.bc_len & 0xFFFFFFFF,
            self.umi_len & 0xFFFFFFFF,
            self.flags & 0xFFFFFFFFFFFFFFFF,
            reserved,
        )

    @classmethod
    def from_bytes(cls, data: bytes) -> "Header":
        """Parse from exactly 32 bytes; does not validate (ref ``header.rs:226-228``)."""
        if len(data) != HEADER_SIZE:
            raise ValueError(
                f"Header.from_bytes requires exactly {HEADER_SIZE} bytes, got {len(data)}"
            )
        magic, version, bc_len, umi_len, flags, reserved = _HEADER_STRUCT.unpack(data)
        return cls(
            magic=magic,
            version=version,
            bc_len=bc_len,
            umi_len=umi_len,
            flags=flags,
            reserved=reserved,
        )

    def to_dict(self) -> dict:
        """Structured serialization (the reference's optional serde feature)."""
        return {
            "magic": self.magic,
            "version": self.version,
            "bc_len": self.bc_len,
            "umi_len": self.umi_len,
            "flags": self.flags,
            "reserved": list(self.reserved),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Header":
        return cls(
            magic=d["magic"],
            version=d["version"],
            bc_len=d["bc_len"],
            umi_len=d["umi_len"],
            flags=d["flags"],
            reserved=bytes(d["reserved"]),
        )

    def __hash__(self) -> int:
        return hash(self.as_bytes())
