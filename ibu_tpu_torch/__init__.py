"""ibu_tpu_torch — the IBU record pipeline in PyTorch, with CUDA kernels
written by hand for NVIDIA Hopper (H100).

A port of :mod:`ibu_tpu` beside it, module for module, that imports nothing
of it. The framework-free host API (header, records, reader, writer, mmap,
errors, the native host runtime) is the port's own copy, under the
reference's module names (:mod:`ibu_tpu_torch.constructs`,
:mod:`ibu_tpu_torch.io`, :mod:`ibu_tpu_torch.errors`,
:mod:`ibu_tpu_torch.native`), and writes the same bytes. Device entry points
live in :mod:`ibu_tpu_torch.pipelines`, :mod:`ibu_tpu_torch.ops` and
:mod:`ibu_tpu_torch.parallel`, and take an explicit ``device``.
"""

from ibu_tpu_torch.constructs import RECORD_DTYPE, RECORD_SIZE, Header, make_records
from ibu_tpu_torch.errors import IbuError, IbuIoError
from ibu_tpu_torch.io import MmapReader, Reader, Writer

__all__ = [
    "RECORD_DTYPE",
    "RECORD_SIZE",
    "Header",
    "IbuError",
    "IbuIoError",
    "MmapReader",
    "Reader",
    "Writer",
    "make_records",
]
