"""The host thread engine.

A copy of :mod:`ibu_tpu.parallel.host`, with the rules of the reference's
``ParallelReader`` (``src/io/mmap.rs:286-332``):

* ``num_threads == 0`` → all cores, else ``min(requested, cores)``
  (``mmap.rs:292-296``);
* a static contiguous partition, ``len // num_threads`` records per worker
  and the remainder to the last (``mmap.rs:297-307``);
* each worker walks its shard in ``BATCH_SIZE`` windows, calling the
  processor per batch, then ``on_batch_complete`` (``mmap.rs:311-320``);
* the first processor error ends the run and is raised again, wrapped as the
  reference's ``IbuError::Process`` (``mmap.rs:326-329``).

Threads scale only where the per-batch work releases the GIL (numpy, native
code): a per-record :class:`ParallelProcessor` is for parity, a
:class:`BatchProcessor` for work.
"""

from __future__ import annotations

import os
import threading

from ibu_tpu_torch.constructs.record import Record
from ibu_tpu_torch.errors import IbuError, into_ibu_error
from ibu_tpu_torch.io.mmap import BATCH_SIZE, MmapReader
from ibu_tpu_torch.parallel.processor import BatchProcessor, ParallelProcessor


def resolve_num_threads(num_threads: int) -> int:
    """``0`` → all cores; else clamp to the core count (ref
    ``mmap.rs:292-296``). A negative count is rejected: it would silently
    process nothing."""
    if num_threads < 0:
        raise ValueError(f"num_threads must be >= 0, got {num_threads}")
    cpus = os.cpu_count() or 1
    if num_threads == 0:
        return cpus
    return min(num_threads, cpus)


def partition(n: int, num_shards: int) -> list[tuple[int, int]]:
    """Static contiguous partition with the remainder appended to the last
    shard (ref ``mmap.rs:297-307``), so shard boundaries are the reference
    engine's per-thread record ranges."""
    if num_shards <= 0:
        raise ValueError(f"num_shards must be positive, got {num_shards}")
    per = n // num_shards
    rem = n % num_shards
    bounds = []
    for i in range(num_shards):
        start = i * per
        end = start + per + (rem if i == num_shards - 1 else 0)
        bounds.append((start, end))
    return bounds


def process_parallel(
    reader: MmapReader,
    processor: ParallelProcessor | BatchProcessor,
    num_threads: int = 0,
    batch_size: int = BATCH_SIZE,
) -> None:
    """Run ``processor`` over every record of ``reader`` on host threads,
    each with its own clone of the reader and of the processor."""
    num_threads = resolve_num_threads(num_threads)
    bounds = partition(reader.len(), num_threads)
    batch_mode = isinstance(processor, BatchProcessor) or (
        hasattr(processor, "process_batch") and not hasattr(processor, "process_record")
    )
    errors: list[BaseException | None] = [None] * num_threads

    def worker(tid: int, start: int, end: int) -> None:
        thread_reader = reader.clone()
        thread_processor = processor.clone()
        thread_processor.set_tid(tid)
        try:
            for batch_start in range(start, end, batch_size):
                chunk = thread_reader.slice(batch_start, min(batch_start + batch_size, end))
                if batch_mode:
                    thread_processor.process_batch(chunk)
                else:
                    for row in chunk:
                        thread_processor.process_record(Record(
                            barcode=int(row["barcode"]), umi=int(row["umi"]),
                            index=int(row["index"])))
                thread_processor.on_batch_complete()
        except BaseException as e:  # noqa: BLE001
            # an exception left uncaught in a thread would be dropped and the
            # run would "succeed" on part of the data: keep it for the join
            errors[tid] = e

    threads = [threading.Thread(target=worker, args=(tid, start, end), daemon=True)
               for tid, (start, end) in enumerate(bounds)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for e in errors:
        if e is not None:
            # IBU errors and interrupts as themselves, the rest wrapped
            if isinstance(e, IbuError) or not isinstance(e, Exception):
                raise e
            raise into_ibu_error(e)
