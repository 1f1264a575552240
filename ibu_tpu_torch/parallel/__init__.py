"""Parallel engines: host threads over the mmap (:mod:`.host`, with the
processor protocols of :mod:`.processor`), map-reduce over record batches on
the device (:mod:`.device`) and engine auto-selection (:mod:`.select`). Only
the host engine is imported here: the device modules import torch."""

from ibu_tpu_torch.parallel.host import partition, process_parallel, resolve_num_threads
from ibu_tpu_torch.parallel.processor import BatchProcessor, ParallelProcessor

__all__ = [
    "BatchProcessor",
    "ParallelProcessor",
    "partition",
    "process_parallel",
    "resolve_num_threads",
]
