"""Device statistics on ``(N, 3)`` int64 records: exact sums, the sort and
the barcode-grouped aggregations.

Counterpart of :mod:`ibu_tpu.ops.stats`. The JAX package sums through a
u16-limb pyramid because the TPU is 32-bit; here an exact mod-2^64 field sum
is a wrapping int64 sum. The record sort sorts each record's bit-compacted
key (:mod:`ibu_tpu_torch.ops.sort_cuda`): a radix sort written for the card,
a plain torch version on the CPU.

The aggregations (:func:`barcode_histogram`, :func:`molecule_counts`,
:func:`pair_molecule_counts`) keep the JAX package's static-size contract:
tables padded to a capacity with the tail zeroed, plus the true distinct
count, which exceeds the capacity on overflow (the caller checks). The
barcode histogram is the histogram engine's group-by
(:mod:`ibu_tpu_torch.ops.group_sum`). The molecule counts sort their rows
with the record sort, unchecked, and segment the sorted rows with boundary
flags and a cumsum; each table slot finds its group's bounds by
``searchsorted`` (a pair key takes two words, and the group-by takes one), so
no record-sized scatter runs and nothing waits on the device. The numpy
oracles are copies of the JAX package's (which cannot be imported here: that
module loads jax).
"""

from __future__ import annotations

import numpy as np
import torch

from ibu_tpu_torch.ops import sort_cuda
from ibu_tpu_torch.ops.group_sum import group_sum
from ibu_tpu_torch.ops.u64 import U64_MASK
from ibu_tpu_torch.utils import trace

_FIELDS = ("barcode", "umi", "index")
_LO32 = 0xFFFFFFFF


def field_sums(records: torch.Tensor) -> torch.Tensor:
    """Per-field wrapping sums of ``(N, 3)`` int64 records → ``(3,)`` int64,
    each the u64 field total mod 2^64 (as int64 bits)."""
    return records.sum(dim=0, dtype=torch.int64)


def checksum_records(records: torch.Tensor) -> tuple[int, int, int]:
    """Exact (barcode_sum, umi_sum, index_sum) mod 2^64 as Python ints."""
    return tuple(int(s) & U64_MASK for s in field_sums(records).tolist())


def checksum_records_np(records: np.ndarray) -> tuple[int, int, int]:
    """Host oracle for :func:`checksum_records` over a structured record array."""
    return tuple(
        int(records[f].sum(dtype=object)) & U64_MASK
        for f in ("barcode", "umi", "index")
    )


def _sort_impl(records: torch.Tensor, hi_used: sort_cuda.Hints) -> torch.Tensor:
    """Sort by (barcode, umi, index) in unsigned order; as in the JAX
    package, hi words dropped by a hint come back as zeros. ``hi_used`` is
    :func:`sort_records`' :class:`~ibu_tpu_torch.ops.sort_cuda.Hints`, which
    carries the batch's field ORs where the check read them; a plain tuple
    of three flags carries none."""
    if not isinstance(hi_used, sort_cuda.Hints):
        hi_used = sort_cuda.Hints(hi_used)
    return sort_cuda.sort_records(records.contiguous(), hi_used)


def sort_records(
    records: torch.Tensor,
    bc_len: int | None = None,
    umi_len: int | None = None,
    index_bits: int | None = None,
    check: bool = True,
) -> torch.Tensor:
    """Lexicographic (barcode, umi, index) sort of ``(N, 3)`` int64 records
    in unsigned u64 order, the order of the IBU ``Record``.

    Hints as in :func:`ibu_tpu.ops.stats.sort_records_soa`: ``bc_len`` /
    ``umi_len`` of at most 16 bases and ``index_bits`` of at most 32 say the
    field's hi 32 bits are zero, which shortens the sort keys. ``check=True``
    verifies that on the device and raises ``ValueError`` on a violated hint;
    with ``check=False`` the hint is trusted and the dropped bits come back as
    zeros.

    The check reads the batch's field ORs on the host, and the sort then
    makes exactly the passes the data's widths need; without it nothing
    waits on the card, and the card skips the passes the data leaves empty.
    """
    hi_used = (
        bc_len is None or bc_len > 16,
        umi_len is None or umi_len > 16,
        index_bits is None or index_bits > 32,
    )
    records = records.contiguous()  # a view is sorted as its rows; no copy otherwise
    hints = sort_cuda.Hints(hi_used)
    if check and not all(hi_used):
        ors = sort_cuda.field_ors(records)
        if ors.is_cuda:
            with trace.span("d2h.wait"):
                trace.count("d2h_bytes", ors.numel() * ors.element_size())
                seen = ors.tolist()
        else:
            seen = ors.tolist()
        bad = [_FIELDS[f] for f in range(3) if not hi_used[f] and seen[f] >> 32]
        if bad:
            raise ValueError(
                f"sort hint violated: {', '.join(bad)} hi word(s) contain "
                "nonzero bits; fix the bc_len/umi_len/index_bits hints"
            )
        hints = sort_cuda.Hints(hi_used, ors, sort_cuda.key_widths(seen, hi_used))
    if records.is_cuda:
        trace.count("sort_passes", sort_cuda.plan(sort_cuda.launch_widths(hints))[1])
    return _sort_impl(records, hints)


# ---------------------------------------------------------------------------
# barcode-grouped aggregations
# ---------------------------------------------------------------------------


def _changed(cols: list[torch.Tensor]) -> torch.Tensor:
    """Flags of the rows where any of ``cols`` differs from the row before;
    row 0 is always flagged."""
    tail = cols[0][1:] != cols[0][:-1]
    for c in cols[1:]:
        tail |= c[1:] != c[:-1]
    # a device-side fill: assigning a host scalar would wait on the card
    head = torch.ones(1, dtype=torch.bool, device=tail.device)
    return torch.cat([head, tail])


def _group_bounds(first: torch.Tensor, n_slots: int):
    """Per table slot ``j``, the bounds ``[start, end)`` of the ``j``-th
    group given its boundary flags (both ``n`` past the last group), and the
    number of groups as a device scalar."""
    seg = torch.cumsum(first, 0) - 1
    slots = torch.arange(n_slots, dtype=seg.dtype, device=seg.device)
    starts = torch.searchsorted(seg, slots, side="left")
    ends = torch.searchsorted(seg, slots, side="right")
    return starts, ends, seg[-1] + 1


def _prefix(flags: torch.Tensor) -> torch.Tensor:
    """``p[i] = flags[:i].sum()`` for ``i`` in ``0..=n``."""
    return torch.nn.functional.pad(torch.cumsum(flags, 0), (1, 0))


def _empty_tables(records: torch.Tensor, size: int, key_shape: tuple = ()):
    """The tables and distinct count of no records."""
    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int64, device=records.device)

    return zeros(size, *key_shape), zeros(size), zeros()


def barcode_histogram(
    records: torch.Tensor, max_uniques: int, bc_len: int | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Records per distinct barcode: ``(keys, counts, num_unique)``, keys and
    counts ``(max_uniques,)`` int64 in ascending unsigned order with the tail
    zeroed, and ``num_unique`` the true distinct count (a 0-d tensor; above
    ``max_uniques`` the groups past the table were dropped).

    ``bc_len <= 16`` is a caller-verified hint that barcode hi words are zero:
    only the lo 32 bits group, and a violated hint mis-groups silently. The
    barcodes are read in place and grouped by
    :func:`ibu_tpu_torch.ops.group_sum.group_sum` with unit weights, its
    passes bounded by 32 key bits under the hint and 64 otherwise.
    """
    if records.shape[0] == 0:
        return _empty_tables(records, max_uniques)
    if bc_len is None or bc_len > 16:
        return group_sum([(records[:, 0], None)], max_uniques, key_bits=64)
    return group_sum([(records[:, 0], None)], max_uniques, key_bits=32, key_mask=_LO32)


def barcode_histogram_np(records: np.ndarray) -> dict[int, int]:
    """Host oracle: barcode → count."""
    vals, counts = np.unique(records["barcode"], return_counts=True)
    return {int(v): int(c) for v, c in zip(vals, counts)}


def molecule_counts(
    records: torch.Tensor,
    max_uniques: int,
    bc_len: int | None = None,
    umi_len: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Distinct ``(barcode, umi)`` pairs per barcode (UMI deduplication):
    ``(keys, mol_counts, num_unique)`` with :func:`barcode_histogram`'s
    contract. ``bc_len``/``umi_len <= 16`` are caller-verified hints."""
    n = records.shape[0]
    if n == 0:
        return _empty_tables(records, max_uniques)
    rows = torch.nn.functional.pad(records[:, :2], (0, 1))  # (barcode, umi, 0)
    rows = _sort_impl(rows, (bc_len is None or bc_len > 16, umi_len is None or umi_len > 16,
                             False))
    bc, umi = rows[:, 0], rows[:, 1]
    bc_first = _changed([bc])
    starts, ends, num_unique = _group_bounds(bc_first, max_uniques)
    pairs = _prefix(bc_first | _changed([umi]))
    mol = pairs[ends] - pairs[starts]
    keys = torch.where(mol > 0, bc[starts.clamp(max=n - 1)], 0)
    return keys, mol, num_unique


def molecule_counts_np(records: np.ndarray) -> dict[int, int]:
    """Host oracle: barcode → number of distinct (barcode, umi) pairs."""
    pairs = np.unique(
        np.stack([records["barcode"], records["umi"]], axis=1), axis=0
    )
    vals, counts = np.unique(pairs[:, 0], return_counts=True)
    return {int(v): int(c) for v, c in zip(vals, counts)}


def pair_molecule_counts(
    records: torch.Tensor,
    max_pairs: int,
    bc_len: int | None = None,
    umi_len: int | None = None,
    index_bits: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Distinct ``(barcode, umi, index)`` triples per ``(barcode, index)``
    pair (the count matrix): ``(pair_keys, counts, num_pairs)`` with
    ``pair_keys`` ``(max_pairs, 2)`` int64 ``[barcode, index]`` in ascending
    unsigned order, the tail zeroed, and ``num_pairs`` the true pair count
    (above ``max_pairs`` means overflow). Hints as in :func:`molecule_counts`,
    plus ``index_bits <= 32``."""
    n = records.shape[0]
    if n == 0:
        return _empty_tables(records, max_pairs, (2,))
    rows = torch.stack([records[:, 0], records[:, 2], records[:, 1]], dim=1)
    rows = _sort_impl(rows, (
        bc_len is None or bc_len > 16,
        index_bits is None or index_bits > 32,
        umi_len is None or umi_len > 16,
    ))
    bc, idx, umi = rows[:, 0], rows[:, 1], rows[:, 2]
    pair_first = _changed([bc, idx])
    starts, ends, num_pairs = _group_bounds(pair_first, max_pairs)
    triples = _prefix(pair_first | _changed([umi]))
    counts = triples[ends] - triples[starts]
    at = starts.clamp(max=n - 1)
    pair_keys = torch.where(
        (counts > 0)[:, None], torch.stack([bc[at], idx[at]], dim=1), 0
    )
    return pair_keys, counts, num_pairs


def pair_molecule_counts_np(records: np.ndarray) -> dict:
    """Host oracle: (barcode, index) → distinct (barcode, umi, index)
    triples."""
    triples = np.unique(
        np.stack(
            [records["barcode"], records["umi"], records["index"]], axis=1
        ),
        axis=0,
    )
    pairs, counts = np.unique(triples[:, [0, 2]], axis=0, return_counts=True)
    return {
        (int(b), int(i)): int(c) for (b, i), c in zip(pairs.tolist(), counts)
    }


def table_dict(keys: torch.Tensor, counts: torch.Tensor) -> dict:
    """Nonzero slots of a static-size table → ``{key: count}`` on the host,
    keys as unsigned ints; a ``(size, 2)`` key table gives tuple keys."""
    keys = keys.cpu().numpy().view(np.uint64)
    counts = counts.cpu().numpy()
    nz = np.flatnonzero(counts)
    if keys.ndim == 2:
        return dict(zip(map(tuple, keys[nz].tolist()), counts[nz].tolist()))
    return dict(zip(keys[nz].tolist(), counts[nz].tolist()))


def group_sum_np(parts) -> tuple[np.ndarray, np.ndarray]:
    """Host merge of sparse ``(keys, counts)`` partials (uint64 keys, each
    part's keys distinct) → ``(keys, sums)``, ascending uint64 keys and int64
    sums: one stable argsort and one ``reduceat``."""
    parts = list(parts)
    if not parts or not sum(len(k) for k, _ in parts):
        return np.empty(0, dtype=np.uint64), np.empty(0, dtype=np.int64)
    keys = np.concatenate([np.asarray(k, dtype=np.uint64) for k, _ in parts])
    counts = np.concatenate([np.asarray(c, dtype=np.int64) for _, c in parts])
    order = np.argsort(keys, kind="stable")
    keys, counts = keys[order], counts[order]
    first = np.ones(len(keys), dtype=bool)
    first[1:] = keys[1:] != keys[:-1]
    starts = np.flatnonzero(first)
    return keys[starts], np.add.reduceat(counts, starts)
