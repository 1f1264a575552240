"""ibu_tpu_torch — the IBU record pipeline in PyTorch, with CUDA kernels
written by hand for NVIDIA Hopper (H100).

A port of :mod:`ibu_tpu` beside it, module for module, that imports nothing
of it. The framework-free host API (header, records, reader, writer, mmap,
errors, the host thread engine, the native host runtime) is the port's own
copy, under the reference's module names (:mod:`ibu_tpu_torch.constructs`,
:mod:`ibu_tpu_torch.io`, :mod:`ibu_tpu_torch.errors`,
:mod:`ibu_tpu_torch.parallel`, :mod:`ibu_tpu_torch.native`), and writes the
same bytes. The public API is flat, with the reference's 33 names::

    from ibu_tpu_torch import Header, Record, Reader, Writer, MmapReader, load_to_vec

Device entry points live in :mod:`ibu_tpu_torch.pipelines`,
:mod:`ibu_tpu_torch.ops` and :mod:`ibu_tpu_torch.parallel.device`, and take an
explicit ``device``; the command line is ``python -m ibu_tpu_torch``.
Importing the package imports no torch, so it creates no CUDA context and
builds no kernel.
"""

from ibu_tpu_torch.constructs import (
    HEADER_SIZE,
    MAGIC,
    RECORD_DTYPE,
    RECORD_SIZE,
    VERSION,
    Header,
    Record,
    empty_records,
    make_records,
    records_from_bytes,
    records_to_bytes,
    sort_records,
)
from ibu_tpu_torch.errors import (
    CompressionError,
    IbuError,
    IbuIoError,
    InvalidBarcodeLength,
    InvalidIndex,
    InvalidMagicNumber,
    InvalidMapSize,
    InvalidUmiLength,
    InvalidVersion,
    ProcessError,
    TruncatedRecord,
    into_ibu_error,
)
from ibu_tpu_torch.io import (
    BATCH_SIZE,
    DEFAULT_BUFFER_RECORDS,
    DEFAULT_BUFFER_SIZE,
    MmapReader,
    Reader,
    Writer,
    load_to_vec,
)
from ibu_tpu_torch.parallel import BatchProcessor, ParallelProcessor, process_parallel

__version__ = "0.1.0"

__all__ = [
    "BATCH_SIZE",
    "BatchProcessor",
    "CompressionError",
    "DEFAULT_BUFFER_RECORDS",
    "DEFAULT_BUFFER_SIZE",
    "HEADER_SIZE",
    "Header",
    "IbuError",
    "IbuIoError",
    "InvalidBarcodeLength",
    "InvalidIndex",
    "InvalidMagicNumber",
    "InvalidMapSize",
    "InvalidUmiLength",
    "InvalidVersion",
    "MAGIC",
    "MmapReader",
    "ParallelProcessor",
    "ProcessError",
    "RECORD_DTYPE",
    "RECORD_SIZE",
    "Reader",
    "Record",
    "TruncatedRecord",
    "VERSION",
    "Writer",
    "empty_records",
    "into_ibu_error",
    "load_to_vec",
    "process_parallel",
    "records_from_bytes",
    "records_to_bytes",
    "sort_records",
]
