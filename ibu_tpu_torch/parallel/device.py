"""Map-reduce over record batches, the flagship statistics and the
per-barcode histogram engines, on one card per process.

Counterpart of :mod:`ibu_tpu.parallel.device`: ``update`` folds each ``(B,
3)`` int64 record batch into a state of tensors that stays on the device until
:meth:`MapReduce.finalize` fetches it. The JAX package shards every batch over
a mesh of devices; here one process drives one card, and a mesh of cards is a
``torch.distributed`` cohort, one rank per card
(:mod:`ibu_tpu_torch.parallel.multihost`). In a cohort of more than one rank,
:meth:`MapReduce.finalize` gathers every rank's state in one collective and
merges them, and :meth:`DeviceHistogram.finalize` merges every rank's table
and spilled counts into the same ``dict`` on every rank. Within a rank the
mesh has one shard, so the JAX package's "per shard" limits and checks are
per batch here, and batches carry no padding.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from ibu_tpu_torch.io.mmap import STREAM_BATCH_RECORDS, MmapReader
from ibu_tpu_torch.ops.stats import (
    _changed,
    _group_bounds,
    _lex_order,
    _prefix,
    barcode_histogram,
    field_sums,
    group_sum_np,
)
from ibu_tpu_torch.ops.u64 import (
    U64_MASK,
    flip_sign,
    records_to_tensor,
    to_device,
    to_host,
    wire_view,
)
from ibu_tpu_torch.utils.device import resolve_device


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


@dataclass(frozen=True)
class MapReduce:
    """Fold over record batches on one device, merged across the ranks of a
    cohort.

    * ``init(device)`` → the initial state, a dict of tensors on ``device``;
    * ``update(state, records)`` → the new state; ``records`` is a ``(B, 3)``
      int64 batch with no padding;
    * ``merge(states)`` → the merge of the host states stacked by rank (each
      leaf ``(P, ...)``, ``P`` the cohort's size; 1 outside a cohort).
      Default: the elementwise sum, which wraps like the int64 sums.
    """

    init: Callable[[torch.device], Any]
    update: Callable[[Any, torch.Tensor], Any]
    merge: Callable[[Any], Any] | None = None

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
        from ibu_tpu_torch.parallel.multihost import process_count

        device = resolve_device(device)
        if state is None:
            state = self.init(device)
        else:
            state = _tree_map(lambda t: t.to(device), state)
        failed = None
        try:
            for records in placed:
                state = self.update(state, records)
        except BaseException as e:
            if process_count() == 1:
                raise
            failed = e  # raised on every rank by finalize's one collective
        return self.finalize(state, failed)

    def finalize(self, state, failed: BaseException | None = None) -> Any:
        """Fetch the state to the host as numpy arrays; in a cohort, gather
        every rank's state in one collective (:func:`_gather_state_tree`) and
        merge. A local ``failed`` travels in that collective and is raised on
        every rank."""
        from ibu_tpu_torch.parallel.multihost import process_count

        host = _tree_map(to_host, state)
        if process_count() == 1:
            if failed is not None:
                raise failed
            if self.merge is None:
                return host
            return self.merge(_tree_map(lambda x: x[None], host))
        stacked = _gather_state_tree(host, failed)
        if self.merge is None:
            return _tree_map(lambda x: x.sum(axis=0), stacked)
        return self.merge(stacked)


def _tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _tree_leaves(v)]
    return [tree]


def _gather_state_tree(tree, failed: BaseException | None = None):
    """Every rank's host state tree, each leaf stacked ``(P, ...)`` by rank,
    in ONE collective: a failure flag and the leaves' bytes packed into one
    buffer, one all-gather over the cohort's Gloo group (every rank's tree
    has the same leaves and shapes, since every rank runs the same engine).
    A flag set on any rank raises on every rank, as
    :func:`ibu_tpu_torch.parallel.multihost._cohort_checkpoint` does."""
    from ibu_tpu_torch.parallel import multihost as MH

    leaves = [np.array(x, order="C") for x in _tree_leaves(tree)]
    buf = np.concatenate(
        [np.array([failed is not None], dtype=np.uint8)]
        + [x.reshape(-1).view(np.uint8) for x in leaves]
    )
    gathered = MH._allgather_host(buf)
    MH._raise_if_failed(gathered[:, 0], failed, "the state merge")
    out, off = [], 1
    for x in leaves:
        part = gathered[:, off:off + x.nbytes]
        out.append(np.ascontiguousarray(part).view(x.dtype).reshape((-1,) + x.shape))
        off += x.nbytes
    stacked = iter(out)
    return _tree_map(lambda _: next(stacked), tree)


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


# ---------------------------------------------------------------------------
# per-barcode histogram
# ---------------------------------------------------------------------------


def bc16_hint(raw: np.ndarray) -> bool:
    """Data-verified "every barcode fits the lo u32 word" hint: one strided
    max over the barcodes' hi words in the ``(B, 3)`` int64 wire view
    (:func:`ibu_tpu_torch.ops.u64.wire_view`). It selects the 32-bit sort key
    in :func:`_masked_histogram`."""
    return len(raw) == 0 or int(raw.view(np.uint32)[:, 1].max()) == 0


def _masked_histogram(records: torch.Tensor, max_uniques: int, bc16: bool = False):
    """One batch's histogram: ``(keys, counts, n_distinct)``, tables of
    ``max_uniques`` and the batch's true distinct count. ``bc16=True``
    (caller-verified: all barcodes < 2^32) sorts 32-bit keys."""
    return barcode_histogram(records, max_uniques, bc_len=16 if bc16 else None)


#: bit 30 of a batch's ``n_seen`` carries the sorted path's order verdict
#: (kept positive, so the max-combined ``shard_seen`` propagates it)
_ORDER_BAD_BIT = 1 << 30


def _masked_histogram_sorted(records: torch.Tensor, max_uniques: int, bc16: bool = False):
    """One SORTED batch's histogram, with no sort: equal barcodes are
    adjacent, so groups come from one adjacent difference. Order is verified
    on the device, not assumed: a decrease anywhere in the batch (in unsigned
    order) sets :data:`_ORDER_BAD_BIT` in the returned ``n_seen``, and
    :func:`_decode_seen` raises on it. A decrease between batches is harmless
    (merging is by key). ``bc16`` is accepted for the JAX signature and
    ignored: an int64 compare covers both words at once."""
    n = records.shape[0]
    if n == 0:
        return barcode_histogram(records, max_uniques)
    bc = records[:, 0]
    starts, ends, n_distinct = _group_bounds(_changed([bc]), max_uniques)
    counts = ends - starts
    keys = torch.where(counts > 0, bc[starts.clamp(max=n - 1)], 0)
    bad = (flip_sign(bc[1:]) < flip_sign(bc[:-1])).any()
    return keys, counts, n_distinct + bad * _ORDER_BAD_BIT


def _decode_seen(seen: int, context: str) -> int:
    """Raise on the order verdict in a max-combined ``n_seen``; else return
    the distinct count it holds."""
    if seen & _ORDER_BAD_BIT:
        raise ValueError(
            f"{context}: the sorted-input fast path saw barcodes out of "
            "nondecreasing order — the file's sorted flag is wrong; "
            "re-sort the file or rerun without assuming sorted input"
        )
    return seen


def _sparse_group_sum(keys: torch.Tensor, weights: torch.Tensor, capacity: int):
    """Group-by-key weight sums of sparse ``(u64 key, weight)`` entries:
    ``(keys, counts, n_distinct)``, the first ``n_distinct`` of the
    ``capacity`` slots holding the distinct valid keys in ascending unsigned
    order with their sums; groups past ``capacity`` are dropped (callers
    guard with ``n_distinct``).

    A weight of 0 marks an empty entry. Validity leads the sort key, so every
    valid group comes before the empties whatever its key: no key value is a
    sentinel, and barcode 0 never merges with an empty slot.
    """
    invalid = weights == 0
    perm = _lex_order([invalid.to(torch.int64), keys], [32, 64])
    keys, weights, invalid = keys[perm], weights[perm], invalid[perm]
    first = _changed([invalid]) | (_changed([keys]) & ~invalid)
    starts, ends, _ = _group_bounds(first, capacity)
    sums = _prefix(weights)
    counts = sums[ends] - sums[starts]
    out = torch.where(counts > 0, keys[starts.clamp(max=keys.shape[0] - 1)], 0)
    return out, counts, (first & ~invalid).sum()


def _sparse_group_sum_spill(
    keys: torch.Tensor, weights: torch.Tensor, capacity: int, ovf_cap: int
):
    """:func:`_sparse_group_sum` with an overflow lane instead of drops: the
    first ``capacity`` distinct keys (the smallest) form the table, the next
    ``ovf_cap`` the overflow lane for the host to absorb. Exact whenever
    ``ovf_cap`` is at least the number of entries past the table, which the
    caller guarantees. Returns ``(keys, counts, n_distinct, ovf_keys,
    ovf_counts, ovf_n)`` with ``ovf_n`` the live overflow slots."""
    out, counts, n_distinct = _sparse_group_sum(keys, weights, capacity + ovf_cap)
    ovf_n = (n_distinct - capacity).clamp(min=0)
    return (out[:capacity], counts[:capacity], n_distinct,
            out[capacity:], counts[capacity:], ovf_n)


def _shard_overflow(seen: int, cap: int) -> ValueError:
    return ValueError(
        f"a shard saw {seen} unique barcodes, over the "
        f"max_uniques_per_shard={cap} capacity; raise the cap or use smaller batches"
    )


def sharded_barcode_histogram(
    batches: Iterable[np.ndarray],
    device: str | torch.device | None = None,
    max_uniques_per_shard: int = 1 << 16,
    sorted_in: bool = False,
) -> dict[int, int]:
    """Barcode → count over host batches: each batch is histogrammed on the
    device, and the sparse results merge on the host (unbounded key space,
    one device→host fetch per batch).

    ``sorted_in=True`` (input known sorted, e.g. a header flag) skips the
    per-batch sort; order is verified on the device and a lying flag raises.
    A batch with more than ``max_uniques_per_shard`` distinct barcodes raises
    ``ValueError`` (its counts would be dropped).
    """
    device = resolve_device(device)
    hist = _masked_histogram_sorted if sorted_in else _masked_histogram
    parts = []
    for batch in batches:
        raw = wire_view(batch)
        keys, counts, seen = hist(to_device(raw, device), max_uniques_per_shard, bc16_hint(raw))
        seen = int(seen)
        if _decode_seen(seen, "sharded_barcode_histogram") > max_uniques_per_shard:
            raise _shard_overflow(seen, max_uniques_per_shard)
        keys, counts = to_host(keys), to_host(counts)
        nz = counts != 0
        parts.append((keys[nz].view(np.uint64), counts[nz]))
    keys, counts = group_sum_np(parts)
    return dict(zip(keys.tolist(), counts.tolist()))


def _fetch_async(t: torch.Tensor):
    """Start a copy of ``t`` to the host: ``(host tensor, event)``, the event
    None on the CPU. Waiting on the event waits for this copy only."""
    if t.device.type == "cpu":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(t.device))
    return host, done


class DeviceHistogram:
    """Device-resident barcode histogram accumulator.

    Where :func:`sharded_barcode_histogram` fetches each batch's result, this
    keeps the running ``barcode → count`` table on the device:

    1. per batch, the batch's histogram (sort + segments, or the sorted fast
       path) is written into one row of a staging buffer;
    2. every ``merge_every`` batches, the staged entries and the table are
       group-summed by key into the new table (:func:`_sparse_group_sum`);
    3. :meth:`finalize` flushes the stage and fetches the table once.

    Table and staging have static sizes, and nothing in :meth:`update_placed`
    waits on the device. Capacity overflow (more than ``capacity`` distinct
    barcodes): with ``spill=True`` each merge routes the groups past the
    table (the largest keys) to an overflow lane, which the next merge (or
    :meth:`finalize`) drains to a host dict after waiting for that merge
    alone, so the result is exact for barcode spaces of any size;
    ``spill=False`` raises at :meth:`finalize`. A batch with more than
    ``max_uniques_per_shard`` distinct barcodes raises at :meth:`finalize`
    either way. Counts are int64.
    """

    def __init__(
        self,
        capacity: int = 1 << 20,
        max_uniques_per_shard: int = 1 << 16,
        merge_every: int = 16,
        spill: bool = True,
        assume_sorted: bool = False,
        device: str | torch.device | None = None,
    ):
        if merge_every < 1:
            raise ValueError(f"merge_every must be >= 1, got {merge_every}")
        self.device = resolve_device(device)
        self.capacity = capacity
        self.max_uniques_per_shard = max_uniques_per_shard
        self.merge_every = merge_every
        self.spill = spill
        #: input claimed sorted: batches skip their sort and verify order
        self.assume_sorted = assume_sorted
        self._filled = 0  # staged batches since the last merge
        self._spilled: dict[int, int] = {}  # host-absorbed overflow
        self._pending = None  # the last merge's overflow lane, not drained

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.int64, device=self.device)

        self._state = {
            "keys": zeros(capacity),
            "cnt": zeros(capacity),
            "n": zeros(),  # most distinct barcodes a merge saw
            "shard_seen": zeros(),  # max over batches of n_seen
            "st_keys": zeros(merge_every, max_uniques_per_shard),
            "st_cnt": zeros(merge_every, max_uniques_per_shard),
        }

    def resume(self, state: dict) -> None:
        """Continue from a table state ``{keys, cnt, n, shard_seen}`` (e.g.
        :func:`ibu_tpu_torch.ops.u64.histogram_state_from_jax`) of the same
        capacity, before any batch is staged."""
        if self._filled or state["keys"].shape != (self.capacity,):
            raise ValueError(
                f"resume needs an empty stage and a table of capacity={self.capacity}"
            )
        for k in ("keys", "cnt", "n", "shard_seen"):
            self._state[k].copy_(state[k])

    def update(self, batch: np.ndarray) -> None:
        """Fold one structured host batch; batches whose barcodes provably
        fit the lo word (one host max) take the 32-bit sort."""
        raw = wire_view(batch)
        self.update_placed(to_device(raw, self.device), bc16=bc16_hint(raw))

    def update_placed(self, records: torch.Tensor, bc16: bool = False) -> None:
        """Fold one ``(B, 3)`` int64 batch already on the device.
        ``bc16=True`` is caller-verified (all barcodes < 2^32)."""
        hist = _masked_histogram_sorted if self.assume_sorted else _masked_histogram
        keys, counts, seen = hist(records, self.max_uniques_per_shard, bc16)
        st = self._state
        st["st_keys"][self._filled] = keys
        st["st_cnt"][self._filled] = counts
        torch.maximum(st["shard_seen"], seen, out=st["shard_seen"])
        self._filled += 1
        if self._filled >= self.merge_every:
            self._run_merge()

    def _run_merge(self) -> None:
        st = self._state
        keys = torch.cat([st["keys"], st["st_keys"].reshape(-1)])
        cnt = torch.cat([st["cnt"], st["st_cnt"].reshape(-1)])
        if self.spill:
            # drain the previous cycle's overflow first: that merge has had
            # merge_every batches of device work to finish
            self._drain_pending()
            # the lane holds every staged entry, so it never drops a group
            lane = self.merge_every * self.max_uniques_per_shard
            st["keys"], st["cnt"], n_distinct, o_keys, o_cnt, ovf_n = (
                _sparse_group_sum_spill(keys, cnt, self.capacity, lane)
            )
            self._pending = (_fetch_async(ovf_n), o_keys, o_cnt)
        else:
            st["keys"], st["cnt"], n_distinct = _sparse_group_sum(keys, cnt, self.capacity)
        torch.maximum(st["n"], n_distinct, out=st["n"])
        st["st_cnt"].zero_()  # a zero count marks an empty staged entry
        self._filled = 0

    def _drain_pending(self) -> None:
        if self._pending is None:
            return
        (ovf_n, done), o_keys, o_cnt = self._pending
        self._pending = None
        if done is not None:
            done.synchronize()
        n = int(ovf_n)
        if n == 0:
            return
        # live groups are a prefix of the lane; fetch a power-of-two prefix
        m = min(1 << (n - 1).bit_length(), o_keys.shape[0])
        keys, cnt = to_host(o_keys[:m]), to_host(o_cnt[:m])
        nz = cnt != 0
        for k, c in zip(keys[nz].view(np.uint64).tolist(), cnt[nz].tolist()):
            self._spilled[k] = self._spilled.get(k, 0) + c

    def finalize(self, failed: BaseException | None = None) -> dict[int, int]:
        """Flush the stage, fetch the table once; returns ``{barcode:
        count}`` (the device table plus any host-spilled overflow).

        In a cohort of more than one rank
        (:mod:`ibu_tpu_torch.parallel.multihost`), every rank's table and
        spilled counts merge into the same ``dict`` on every rank, and the
        two checks read the whole cohort (the largest ``n_seen`` and distinct
        count of any rank, and the merged distinct count), so they raise on
        every rank together with the same text. ``failed``, an error of this
        rank's batch loop, is then raised on every rank too."""
        from ibu_tpu_torch.parallel import multihost as MH

        if MH.process_count() > 1:
            return self._finalize_cohort(failed)
        if failed is not None:
            raise failed
        seen, n, keys, cnt = self._local_table()
        self._check(seen, n)
        out = dict(zip(keys.view(np.uint64).tolist(), cnt.tolist()))
        # a spilled key can re-enter the table later, so counts add
        for k, c in self._spilled.items():
            out[k] = out.get(k, 0) + c
        return out

    def _local_table(self):
        """This rank's ``(n_seen, n, keys, counts)``: the flushed table's
        live entries, keys as int64 bits."""
        if self._filled:
            self._run_merge()
        self._drain_pending()
        st = {k: to_host(self._state[k]) for k in ("keys", "cnt", "n", "shard_seen")}
        nz = st["cnt"] != 0
        return int(st["shard_seen"]), int(st["n"]), st["keys"][nz], st["cnt"][nz]

    def _check(self, seen: int, n: int) -> None:
        if _decode_seen(seen, "DeviceHistogram") > self.max_uniques_per_shard:
            raise _shard_overflow(seen, self.max_uniques_per_shard)
        if not self.spill and n > self.capacity:
            raise ValueError(
                f"{n} distinct barcodes exceed the device table "
                f"capacity={self.capacity}; raise capacity, enable "
                "spill=True, or use sharded_barcode_histogram (host merge)"
            )

    def _finalize_cohort(self, failed: BaseException | None) -> dict[int, int]:
        from ibu_tpu_torch.parallel import multihost as MH

        seen, n = 0, 0
        entries = np.zeros((2, 0), dtype=np.int64)
        try:
            if failed is None:
                seen, n, keys, cnt = self._local_table()
                spilled = np.array(list(self._spilled.items()), dtype=np.uint64).reshape(-1, 2)
                entries = np.stack([
                    np.concatenate([keys, spilled[:, 0].view(np.int64)]),
                    np.concatenate([cnt, spilled[:, 1].astype(np.int64)]),
                ])
        except BaseException as e:
            failed = e
        lanes = MH._cohort_checkpoint(failed, "the histogram merge",
                                      (seen, n, entries.shape[1]))
        parts = MH._allgather_varlen(entries, lanes[:, 2])
        keys, cnt = group_sum_np((e[0].view(np.uint64), e[1]) for e in parts)
        self._check(int(lanes[:, 0].max()), max(int(lanes[:, 1].max()), len(keys)))
        return dict(zip(keys.tolist(), cnt.tolist()))

    def run(self, batches: Iterable[np.ndarray]) -> dict[int, int]:
        """Fold all ``batches`` and finalize."""
        for batch in batches:
            self.update(batch)
        return self.finalize()


def stream_file_histogram(
    reader: MmapReader,
    device: str | torch.device | None = None,
    batch_records: int = STREAM_BATCH_RECORDS,
    capacity: int = 1 << 20,
    max_uniques_per_shard: int = 1 << 16,
    spill: bool = True,
    assume_sorted: bool | None = None,
) -> dict[int, int]:
    """Per-barcode counts of a whole file, streamed to the device with
    prefetch into a :class:`DeviceHistogram`. ``assume_sorted=None`` trusts
    the header's sorted flag: sorted files skip the per-batch sort, and a
    lying flag raises rather than miscounting."""
    from ibu_tpu_torch.io.stream import stream_file

    if assume_sorted is None:
        assume_sorted = reader.header().sorted()
    device = resolve_device(device)
    hist = DeviceHistogram(
        capacity=capacity,
        max_uniques_per_shard=max_uniques_per_shard,
        spill=spill,
        assume_sorted=assume_sorted,
        device=device,
    )
    for records, bc16 in stream_file(
        reader, device=device, batch_records=batch_records, with_hint=True
    ):
        hist.update_placed(records, bc16=bc16)
    return hist.finalize()
