"""Wire-format core: the 32-byte header and the 24-byte record.

A copy of :mod:`ibu_tpu.constructs` (the parts the port uses), so that the
port runs without the JAX package beside it.
"""

from ibu_tpu_torch.constructs.header import HEADER_SIZE, MAGIC, VERSION, Header
from ibu_tpu_torch.constructs.record import (
    RECORD_DTYPE,
    RECORD_SIZE,
    Record,
    empty_records,
    make_records,
    records_from_bytes,
    records_to_bytes,
    sort_records,
)

__all__ = [
    "HEADER_SIZE",
    "MAGIC",
    "VERSION",
    "Header",
    "RECORD_DTYPE",
    "RECORD_SIZE",
    "Record",
    "empty_records",
    "make_records",
    "records_from_bytes",
    "records_to_bytes",
    "sort_records",
]
