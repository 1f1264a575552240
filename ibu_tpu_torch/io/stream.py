"""Host→device record streaming with prefetch.

Counterpart of :class:`ibu_tpu.io.stream.DeviceStream`. Each host batch of
structured records is copied into one of a ring of pinned host buffers and
sent to the card as an ``(B, 3)`` int64 tensor by an asynchronous copy on a
side stream, so the copies of upcoming batches overlap the consumer's work on
the current one. Up to ``prefetch`` batches are in flight
(:func:`prefetched`, a copy of :func:`ibu_tpu.io.stream.prefetched`).

Ordering rules the ring keeps:

* a pinned buffer is refilled only after the event recorded behind its last
  copy has completed;
* the consumer's stream waits on a batch's copy event when the batch is
  handed out, not when it is queued, so work on earlier batches is not held
  behind later copies;
* each batch tensor is allocated on the side stream and marked with
  ``record_stream`` for the consumer's stream, so the allocator does not
  reuse its memory while the consumer still reads it.

On the CPU a batch is simply copied into its own tensor. With
``with_hint=True`` each item is ``(batch, bc16)``, the histogram engines'
"every barcode fits the lo word" hint computed on the host wire view before
the copy (:func:`ibu_tpu_torch.parallel.device.bc16_hint`).
"""

from __future__ import annotations

import os
import queue
import threading
from collections import deque
from typing import Iterable, Iterator

import numpy as np
import torch

from ibu_tpu_torch.io.mmap import STREAM_BATCH_RECORDS, STREAM_PREFETCH, MmapReader
from ibu_tpu_torch.ops.u64 import wire_view
from ibu_tpu_torch.parallel.device import bc16_hint, record_batches_from_mmap
from ibu_tpu_torch.utils import trace
from ibu_tpu_torch.utils.device import resolve_device


def prefetched(items, depth: int):
    """Iterate ``items`` with up to ``depth`` values produced ahead of the
    consumer. The queue refills both before and after each yield, so the
    production of upcoming items (mmap faults, copies queued on the card)
    overlaps the consumer's work on the current one."""
    depth = max(1, depth)
    queue: deque = deque()
    it = iter(items)
    exhausted = False

    def fill():
        nonlocal exhausted
        while not exhausted and len(queue) < depth:
            try:
                queue.append(next(it))
            except StopIteration:
                exhausted = True

    while True:
        fill()
        if not queue:
            return
        item = queue.popleft()
        fill()
        yield item


def thread_prefetched(items, depth: int = 2):
    """Produce ``items`` in a background thread, up to ``depth`` ahead (a
    copy of :func:`ibu_tpu.io.stream.thread_prefetched`).

    :func:`prefetched` runs production on the consumer's thread; this moves
    it onto its own thread, so CPU-bound producers (gzip/zstd decompression,
    FASTQ parsing) overlap the consumer's own work too: numpy and the native
    parser release the GIL inside their loops. An exception raised by the
    producer re-raises at the consumer's next pull; abandoning the generator
    (an early ``break`` or ``close``) stops the producer promptly instead of
    leaving it blocked on a full queue. The producer makes no CUDA call:
    every launch and copy stays on the consumer's thread.
    """
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    END = object()
    stop = threading.Event()
    err: list = []

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def produce():
        try:
            for item in items:
                if not _put(item):
                    return
        except BaseException as e:  # noqa: BLE001 (re-raised in the consumer)
            err.append(e)
        finally:
            _put(END)

    t = threading.Thread(target=produce, daemon=True, name="ibu-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is END:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()


class DeviceStream:
    """Prefetching iterator of device-resident ``(B, 3)`` int64 record
    batches made from an iterator of structured host batches (with
    ``with_hint``, of ``(batch, bc16)`` pairs)."""

    def __init__(
        self,
        batches: Iterable[np.ndarray],
        device: str | torch.device | None = None,
        prefetch: int = STREAM_PREFETCH,
        with_hint: bool = False,
    ):
        self._device = resolve_device(device)
        self._batches = iter(batches)
        self._with_hint = with_hint
        depth = max(1, prefetch)
        if self._device.type == "cuda":
            self._copy_stream = torch.cuda.Stream(self._device)
            # one more buffer than batches in flight: the consumer's batch
            # keeps its buffer while `depth` later ones are being filled
            self._ring: list[list] = [[None, None] for _ in range(depth + 1)]
            self._iter = prefetched(self._copy_all(), depth)
        else:
            self._iter = prefetched(self._copy_all_cpu(), depth)

    def _hint(self, host: np.ndarray) -> bool | None:
        if not self._with_hint:
            return None
        # the first touch of the batch's pages when it is a view of a mapping
        with trace.span("stream.hint"):
            return bc16_hint(host)

    def _copy_all_cpu(self):
        for batch in self._batches:
            host = wire_view(batch)
            yield torch.from_numpy(host.copy()), None, self._hint(host)

    def _copy_all(self) -> Iterator[tuple[torch.Tensor, torch.cuda.Event, bool | None]]:
        for k, batch in enumerate(self._batches):
            host = wire_view(batch)
            hint = self._hint(host)
            slot = self._ring[k % len(self._ring)]
            buf, done = slot
            if done is not None:
                with trace.span("stream.slot_wait"):
                    done.synchronize()
            if buf is None or buf.shape[0] < host.shape[0]:
                with trace.span("h2d.pinned_alloc"):
                    buf = torch.empty(host.shape, dtype=torch.int64, pin_memory=True)
            staged = buf[: host.shape[0]]
            with trace.span("h2d.stage"):
                trace.count("staged_bytes", host.nbytes)
                staged.numpy()[...] = host
            with torch.cuda.stream(self._copy_stream):
                dev = torch.empty(host.shape, dtype=torch.int64, device=self._device)
                dev.copy_(staged, non_blocking=True)
                trace.count("h2d_bytes", host.nbytes)
                done = torch.cuda.Event()
                done.record(self._copy_stream)
            slot[0], slot[1] = buf, done
            yield dev, done, hint

    def __iter__(self):
        return self

    def __next__(self) -> torch.Tensor | tuple[torch.Tensor, bool]:
        dev, done, hint = next(self._iter)
        if done is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(done)
            dev.record_stream(consumer)
        return (dev, hint) if self._with_hint else dev


def stream_file(
    path_or_reader: str | MmapReader,
    device: str | torch.device | None = None,
    batch_records: int = STREAM_BATCH_RECORDS,
    prefetch: int = STREAM_PREFETCH,
    with_hint: bool = False,
) -> DeviceStream:
    """Stream an IBU file (a path, or an open :class:`MmapReader`) to the
    device in ``batch_records`` batches; the last batch is ragged."""
    reader = (
        MmapReader(path_or_reader)
        if isinstance(path_or_reader, (str, os.PathLike))
        else path_or_reader
    )
    return DeviceStream(
        record_batches_from_mmap(reader, batch_records),
        device=device,
        prefetch=prefetch,
        with_hint=with_hint,
    )
