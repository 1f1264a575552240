"""Processor protocols of the host thread engine.

A copy of :mod:`ibu_tpu.parallel.processor`. The reference's extension point
is ``ParallelProcessor``, a per-record callback (``src/parallel.rs:100-189``),
kept here for parity; :class:`BatchProcessor` is the batch-first form, whose
``process_batch`` receives a structured-array view of up to ``BATCH_SIZE``
records of the map, so its work can be vectorized numpy that releases the
GIL. :func:`ibu_tpu_torch.parallel.host.process_parallel` runs either.
"""

from __future__ import annotations

import copy

from ibu_tpu_torch.constructs.record import Record


class ParallelProcessor:
    """Per-record processor (ref ``parallel.rs:100-189``).

    Each worker thread gets its own :meth:`clone` (a deep copy by default,
    the reference's ``Send + Clone`` bound): it accumulates in
    ``process_record`` and merges into shared state in
    ``on_batch_complete``. The reference's ``Arc<Mutex<…>>`` target becomes a
    plain shared list here (``list.append`` is atomic under the GIL):

    >>> import os, tempfile
    >>> import numpy as np
    >>> from ibu_tpu_torch import Header, MmapReader, Writer
    >>> from ibu_tpu_torch.constructs.record import RECORD_DTYPE
    >>> from ibu_tpu_torch.parallel import ParallelProcessor
    >>> class SumBarcodes(ParallelProcessor):
    ...     def __init__(self, totals):
    ...         self.local = 0       # thread-local accumulator
    ...         self.totals = totals  # shared merge target
    ...     def process_record(self, record):
    ...         self.local += record.barcode
    ...     def on_batch_complete(self):  # the merge point
    ...         self.totals.append(self.local)
    ...         self.local = 0
    ...     def clone(self):  # duplicate local state, share the target
    ...         return SumBarcodes(self.totals)
    >>> path = os.path.join(tempfile.mkdtemp(), "doc.ibu")
    >>> recs = np.zeros(100, dtype=RECORD_DTYPE)
    >>> recs["barcode"] = np.arange(100)
    >>> with Writer.from_path(path, Header.new(16, 12)) as w:
    ...     w.write_batch(recs)
    >>> processor = SumBarcodes([])
    >>> MmapReader(path).process_parallel(processor, num_threads=2)
    >>> sum(processor.totals)  # == 0 + 1 + ... + 99
    4950
    >>> os.remove(path)
    """

    def process_record(self, record: Record) -> None:
        raise NotImplementedError

    def on_batch_complete(self) -> None:
        """Called after each batch: merge thread-local state into shared
        state here (ref ``parallel.rs:162-164``). Default: nothing."""

    def set_tid(self, tid: int) -> None:
        """Record the worker's thread id (ref ``parallel.rs:179-183``)."""
        self._tid = tid

    def get_tid(self) -> int | None:
        return getattr(self, "_tid", None)

    def clone(self) -> "ParallelProcessor":
        """A deep copy by default, the analogue of a derived ``Clone``.
        Override where the processor holds shared state on purpose: copy the
        thread-local parts and carry the shared references over (a shallow
        copy would share the accumulators between workers)."""
        return copy.deepcopy(self)


class BatchProcessor:
    """Batch-first processor: ``process_batch`` receives a zero-copy
    structured-array view of up to ``BATCH_SIZE`` records; vectorized work
    there keeps the hot loop out of Python. ``on_batch_complete`` keeps the
    reference's merge point."""

    def process_batch(self, records) -> None:
        raise NotImplementedError

    def on_batch_complete(self) -> None:
        """Merge point after each batch. Default: nothing."""

    def set_tid(self, tid: int) -> None:
        self._tid = tid

    def get_tid(self) -> int | None:
        return getattr(self, "_tid", None)

    def clone(self) -> "BatchProcessor":
        """A deep copy by default; override to share state (see
        :meth:`ParallelProcessor.clone`)."""
        return copy.deepcopy(self)
