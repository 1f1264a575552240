"""Host I/O: the streaming reader and writer, the bulk loader, the mmap
reader and gzip/zstd compression (copies of :mod:`ibu_tpu.io`'s), and
host→device record streaming (:mod:`ibu_tpu_torch.io.stream`, which imports
torch and so is not imported here)."""

from ibu_tpu_torch.io.compression import open_compressed, wrap_compress
from ibu_tpu_torch.io.mmap import BATCH_SIZE, MmapReader
from ibu_tpu_torch.io.reader import (
    DEFAULT_BUFFER_RECORDS,
    DEFAULT_BUFFER_SIZE,
    Reader,
    load_to_vec,
)
from ibu_tpu_torch.io.writer import Writer

__all__ = [
    "BATCH_SIZE",
    "DEFAULT_BUFFER_RECORDS",
    "DEFAULT_BUFFER_SIZE",
    "MmapReader",
    "Reader",
    "Writer",
    "load_to_vec",
    "open_compressed",
    "wrap_compress",
]
