"""Single-device map-reduce over record batches, and the flagship statistics.

Counterpart of :mod:`ibu_tpu.parallel.device` for one card: ``update`` folds
each ``(B, 3)`` int64 record batch into a state of tensors that stays on the
device until :meth:`MapReduce.finalize` fetches it. The JAX package shards
every batch over a mesh and merges the shards at the end; the merge across
cards (``torch.distributed``) is not part of this package yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from ibu_tpu.io.mmap import STREAM_BATCH_RECORDS, MmapReader
from ibu_tpu_torch.ops.stats import field_sums
from ibu_tpu_torch.ops.u64 import U64_MASK, records_to_tensor
from ibu_tpu_torch.utils.device import resolve_device


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


@dataclass(frozen=True)
class MapReduce:
    """Fold over record batches on one device.

    * ``init(device)`` → the initial state, a dict of tensors on ``device``;
    * ``update(state, records)`` → the new state; ``records`` is a ``(B, 3)``
      int64 batch with no padding.
    """

    init: Callable[[torch.device], Any]
    update: Callable[[Any, torch.Tensor], Any]

    def run(
        self,
        batches: Iterable[np.ndarray],
        device: str | torch.device | None = None,
        state: Any = None,
    ) -> Any:
        """Fold ``update`` over structured host batches (each copied to the
        device in turn), starting from ``state`` or ``init``."""
        device = resolve_device(device)
        return self.run_placed(
            (records_to_tensor(b, device) for b in batches), device, state
        )

    def run_placed(
        self,
        placed: Iterable[torch.Tensor],
        device: str | torch.device | None = None,
        state: Any = None,
    ) -> Any:
        """Fold ``update`` over batches already on the device (e.g. a
        :class:`ibu_tpu_torch.io.stream.DeviceStream`)."""
        device = resolve_device(device)
        if state is None:
            state = self.init(device)
        else:
            state = _tree_map(lambda t: t.to(device), state)
        for records in placed:
            state = self.update(state, records)
        return self.finalize(state)

    @staticmethod
    def finalize(state) -> Any:
        """Fetch the state to the host as numpy arrays."""
        return _tree_map(lambda t: t.cpu().numpy(), state)


# ---------------------------------------------------------------------------
# flagship statistics: count + exact u64 checksums
# ---------------------------------------------------------------------------


def _stats_init(device: torch.device) -> dict:
    return {
        "count": torch.zeros((), dtype=torch.int64, device=device),
        "sums": torch.zeros((3,), dtype=torch.int64, device=device),
    }


def _stats_update(state: dict, records: torch.Tensor) -> dict:
    return {
        "count": state["count"] + records.shape[0],
        "sums": state["sums"] + field_sums(records),
    }


STATS_MAP_REDUCE = MapReduce(init=_stats_init, update=_stats_update)


def finalize_stats(merged) -> dict:
    """Host form of a finalized stats state: Python ints, sums mod 2^64."""
    sums = [int(s) & U64_MASK for s in np.asarray(merged["sums"]).tolist()]
    return {
        "count": int(merged["count"]),
        "barcode_sum": sums[0],
        "umi_sum": sums[1],
        "index_sum": sums[2],
    }


def record_batches_from_mmap(
    reader: MmapReader, batch_records: int = STREAM_BATCH_RECORDS
) -> Iterator[np.ndarray]:
    """Zero-copy structured batches of ``batch_records`` off the mapping."""
    n = reader.len()
    for start in range(0, n, batch_records):
        yield reader.slice(start, min(start + batch_records, n))


def stream_file_stats(
    reader: MmapReader,
    device: str | torch.device | None = None,
    batch_records: int = STREAM_BATCH_RECORDS,
) -> dict:
    """Count + exact field checksums of a whole file, streamed to the device
    with prefetch."""
    from ibu_tpu_torch.io.stream import stream_file

    device = resolve_device(device)
    merged = STATS_MAP_REDUCE.run_placed(
        stream_file(reader, device=device, batch_records=batch_records), device
    )
    return finalize_stats(merged)


def sharded_stats(records: np.ndarray, device: str | torch.device | None = None) -> dict:
    """One-shot count + checksums of an in-memory structured record array."""
    return finalize_stats(STATS_MAP_REDUCE.run(iter([records]), device))
