"""Host I/O: the streaming reader and writer, the bulk loader, the mmap
reader and gzip/zstd compression (copies of :mod:`ibu_tpu.io`'s), and
host→device record streaming (:mod:`ibu_tpu_torch.io.stream`)."""

from ibu_tpu_torch.io.mmap import BATCH_SIZE, MmapReader
from ibu_tpu_torch.io.reader import Reader, load_to_vec
from ibu_tpu_torch.io.writer import Writer

__all__ = ["BATCH_SIZE", "MmapReader", "Reader", "Writer", "load_to_vec"]
