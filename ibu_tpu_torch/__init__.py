"""ibu_tpu_torch — the IBU record pipeline in PyTorch, with CUDA kernels
written by hand for NVIDIA Hopper (H100).

A port of :mod:`ibu_tpu` beside it, module for module. The framework-free
host API (header, records, reader, writer, mmap, errors, native runtime) is
shared with :mod:`ibu_tpu` and re-exported here; importing either package
loads no jax. Device entry points live in :mod:`ibu_tpu_torch.pipelines`,
:mod:`ibu_tpu_torch.ops` and :mod:`ibu_tpu_torch.parallel`, and take an
explicit ``device``.
"""

from ibu_tpu import (
    RECORD_DTYPE,
    RECORD_SIZE,
    Header,
    IbuError,
    IbuIoError,
    MmapReader,
    Reader,
    Writer,
)
from ibu_tpu.constructs.record import make_records

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
