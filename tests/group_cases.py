"""Cases of the histogram engine's group-by (``ibu_tpu_torch.ops.group_sum``)
and the torch chain it replaced, shared by the CPU tests
(``test_torch_group_sum.py``, against the JAX package) and the card tests
(``test_torch_cuda.py``, which import no jax).

A batch case is ``(records, max_uniques, bc16)``: ``(N, 3)`` int64 records
whose barcodes are histogrammed with unit weights. A merge case is ``(parts,
capacity, lane)``: the device table and staged batch tables, each ``(keys,
counts)`` with a count of 0 marking an empty entry, merged into ``capacity``
table slots and a spill lane of ``lane`` slots. Keys are u64 bits in int64.
"""

from __future__ import annotations

import numpy as np
import torch

from ibu_tpu_torch.ops.group_sum import group_sum
from ibu_tpu_torch.ops.stats import _changed, _group_bounds, _prefix
from ibu_tpu_torch.ops.u64 import SIGN_BIT, flip_sign

U64_MAX = (1 << 64) - 1
_LO32 = 0xFFFFFFFF
_HALF32 = 1 << 31


def width_keys(rng, n: int, bits: int) -> np.ndarray:
    """``n`` keys of exactly ``bits`` bits (one with bit ``bits - 1`` set),
    as int64 bits."""
    if bits == 0:
        return np.zeros(n, np.int64)
    keys = rng.integers(0, 1 << bits, n, dtype=np.uint64)
    keys[rng.integers(0, n)] |= np.uint64(1 << (bits - 1))
    return keys.view(np.int64)


def pooled(rng, n: int, pool: np.ndarray, hot: float = 0.0) -> np.ndarray:
    """``n`` draws from ``pool``; a share ``hot`` of them its first key."""
    out = pool[rng.integers(0, len(pool), n)]
    out[rng.random(n) < hot] = pool[0]
    return out


def batch(seed: int, n: int, bits: int, pool: int, hot: float = 0.0) -> np.ndarray:
    """``(n, 3)`` records whose barcodes come from a pool of ``pool``
    ``bits``-bit keys (0 and the u64 maximum among them at 64 bits)."""
    rng = np.random.default_rng(seed)
    keys = width_keys(rng, pool, bits)
    if bits == 64:
        keys[1:3] = (0, -1)
    records = rng.integers(-(1 << 63), (1 << 63) - 1, (n, 3), dtype=np.int64)
    records[:, 0] = pooled(rng, n, keys, hot)
    return records


def with_barcodes(seed: int, barcodes: np.ndarray) -> np.ndarray:
    """``(n, 3)`` records whose barcodes are ``barcodes`` (int64 bits), the
    other fields random."""
    rng = np.random.default_rng(seed)
    records = rng.integers(-(1 << 63), (1 << 63) - 1, (len(barcodes), 3), dtype=np.int64)
    records[:, 0] = barcodes
    return records


def one_digit_pass(seed: int, n: int) -> np.ndarray:
    """24-bit barcodes whose middle byte is 0xAB in every record: every key
    has one digit in the second pass and random ones in the first and third."""
    rng = np.random.default_rng(seed)
    bc = rng.integers(0, 1 << 24, n, dtype=np.int64) & ~np.int64(0xFF00) | np.int64(0xAB00)
    return with_barcodes(seed, bc)


def in_order(seed: int, n: int, pool: int, reverse: bool) -> np.ndarray:
    """Barcodes of 24 bits from a pool of ``pool``, in ascending or
    descending order."""
    rng = np.random.default_rng(seed)
    bc = np.sort(pooled(rng, n, width_keys(rng, pool, 24)))
    return with_barcodes(seed, bc[::-1] if reverse else bc)


#: name → (records, max_uniques, bc16): key widths 0 to 64 around the word
#: and hint edges, a hot barcode whose run crosses many 1024-entry tiles,
#: more groups than slots, one record, a size that is no multiple of any
#: block, and hi bits under the 32-bit hint (grouped by the lo word alone);
#: then the rank's edges: each warp's 32 keys of distinct digits (barcodes
#: counting up), one digit in every key in one pass, keys in order and in
#: reverse, and exactly one 4096-key tile and one key more
BATCH_CASES = {
    "w0": (lambda: batch(1, 5003, 0, 1), 64, False),
    "w1": (lambda: batch(2, 5003, 1, 2), 64, True),
    "w24": (lambda: batch(3, 20_011, 24, 3000), 4096, True),
    "w32": (lambda: batch(4, 20_011, 32, 3000), 4096, True),
    "w48": (lambda: batch(5, 20_011, 48, 3000), 4096, False),
    "w64": (lambda: batch(6, 20_011, 64, 3000), 4096, False),
    "hot_key": (lambda: batch(7, 20_011, 48, 500, hot=0.9), 1024, False),
    "more_groups_than_slots": (lambda: batch(8, 20_011, 64, 3000), 256, False),
    "n1": (lambda: batch(9, 1, 24, 1), 16, True),
    "violated_hint": (lambda: batch(10, 5003, 64, 300), 1024, True),
    "distinct_digits": (lambda: with_barcodes(24, np.arange(20_011, dtype=np.int64) + 77),
                        32768, True),
    "one_digit_pass": (lambda: one_digit_pass(25, 20_011), 32768, True),
    "sorted": (lambda: in_order(26, 20_011, 3000, False), 4096, True),
    "reversed": (lambda: in_order(27, 20_011, 3000, True), 4096, True),
    "one_tile": (lambda: batch(28, 4096, 24, 1000), 1024, True),
    "one_tile_plus_one": (lambda: batch(29, 4097, 24, 1000), 1024, True),
}


def table(rng, capacity: int, keys: np.ndarray, fill: int, max_count: int) -> tuple:
    """A table of ``capacity`` slots whose first ``fill`` hold distinct
    ``keys`` in ascending unsigned order with counts in ``[1, max_count]``;
    the rest are empty (key 0, count 0)."""
    live = np.unique(keys.view(np.uint64))[:fill].view(np.int64)
    k = np.zeros(capacity, np.int64)
    c = np.zeros(capacity, np.int64)
    k[:len(live)] = live
    c[:len(live)] = rng.integers(1, max_count + 1, len(live))
    return k, c


def merge(seed: int, bits: int, capacity: int, rows: int, row_slots: int, pool: int,
          fill: float = 0.8, max_count: int = 1 << 20, stale: bool = False) -> list:
    """The table (filled to ``fill``) and ``rows`` staged tables of
    ``row_slots`` slots over a pool of ``pool`` ``bits``-bit keys; with
    ``stale`` the empty slots of the staged tables keep old keys, as a
    part-filled stage does."""
    rng = np.random.default_rng(seed)
    keys = width_keys(rng, pool, bits)
    if bits == 64:
        keys[1:3] = (0, -1)
    parts = [table(rng, capacity, keys[rng.integers(0, pool, capacity)],
                   int(capacity * fill), max_count)]
    for r in range(rows):
        k, c = table(rng, row_slots, keys[rng.integers(0, pool, row_slots)],
                     int(row_slots * fill), 1 << 10)
        if stale:
            k[c == 0] = rng.integers(1, 1 << 62, int((c == 0).sum()))
        parts.append((k, c))
    return parts


def zero_among_empties() -> list:
    """Barcode 0 with counts in the table and a staged row, beside empty
    slots whose key is 0 too."""
    return [(np.array([0, 7, 0, 0], np.int64), np.array([5, 2, 0, 0], np.int64)),
            (np.array([0, 3, 0], np.int64), np.array([4, 1, 0], np.int64))]


#: name → (parts, capacity, lane); the rank's edges last: exactly one
#: 4096-entry tile of one-word keys and one entry more, and keys that recur
#: in 41 parts with other counts, so that entries tie in every key digit and
#: only the passes' stability keeps their counts' order, at one and two key
#: words (the host's bound) and three (the widest)
MERGE_CASES = {
    "w0": (lambda: merge(11, 0, 64, 3, 32, 1), 64, 0),
    "w1": (lambda: merge(12, 1, 64, 3, 32, 2), 64, 96),
    "w24": (lambda: merge(13, 24, 4096, 5, 1024, 6000), 4096, 5 * 1024),
    "w32": (lambda: merge(14, 32, 4096, 5, 1024, 6000), 4096, 5 * 1024),
    "w48": (lambda: merge(15, 48, 4096, 5, 1024, 6000), 4096, 5 * 1024),
    "w64": (lambda: merge(16, 64, 4096, 5, 1024, 6000, max_count=1 << 28), 4096, 5 * 1024),
    "zero_among_empties": (zero_among_empties, 4, 6),
    "stale_keys": (lambda: merge(17, 48, 1024, 4, 512, 3000, fill=0.5, stale=True), 1024,
                   4 * 512),
    "more_groups_than_slots": (lambda: merge(18, 48, 512, 4, 512, 6000), 512, 0),
    "spill": (lambda: merge(19, 64, 512, 6, 512, 20_000), 512, 6 * 512),
    "n1": (lambda: [(np.array([9], np.int64), np.array([3], np.int64))], 1, 0),
    "all_empty": (lambda: merge(20, 24, 1000, 3, 333, 10, fill=0.0), 1000, 999),
    "odd_sizes": (lambda: merge(21, 40, 100_003, 2, 7919, 150_000), 100_003, 2 * 7919),
    "one_tile": (lambda: merge(30, 24, 2048, 2, 1024, 3000), 2048, 2 * 1024),
    "one_tile_plus_one": (lambda: merge(31, 24, 2049, 2, 1024, 3000), 2049, 2 * 1024),
    "ties_w24": (lambda: merge(32, 24, 2048, 40, 2048, 2048, fill=1.0), 2048, 40 * 2048),
    "ties_w48": (lambda: merge(33, 48, 2048, 40, 2048, 2048, fill=1.0), 2048, 40 * 2048),
}


def to(device, *arrays) -> list[torch.Tensor]:
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]


def bounds(parts) -> dict:
    """The merge's bound from what the host knows of the parts: their keys'
    widest word and the bit length of the largest count."""
    keys = np.concatenate([k for k, _ in parts]).view(np.uint64)
    counts = np.concatenate([c for _, c in parts])
    key_bits = 32 if not len(keys) or int(keys.max()) >> 32 == 0 else 64
    return {"key_bits": key_bits, "count_bits": int(counts.max(initial=0)).bit_length()}


def merged(parts, capacity: int, lane: int, device, **bits):
    """``group_sum`` of a merge case: ``(keys, counts, n_distinct, lane
    keys, lane counts, live lane slots)``, as the engine splits it."""
    tensors = [tuple(to(device, k, c)) for k, c in parts]
    keys, counts, n = group_sum(tensors, capacity + lane, **(bits or bounds(parts)))
    return (keys[:capacity], counts[:capacity], n, keys[capacity:], counts[capacity:],
            (n - capacity).clamp(min=0))


# ---------------------------------------------------------------------------
# the chain the group-by kernels replaced (sort, flags, cumsum, searchsorted,
# gathers), as ibu_tpu_torch.ops.stats and parallel/device.py held it
# ---------------------------------------------------------------------------


def stable_argsort2(major: torch.Tensor, minor: torch.Tensor) -> torch.Tensor:
    """The permutation sorting rows by ``(major, minor)`` in unsigned order:
    stable argsorts of the sign-flipped keys, the minor key first."""
    perm = torch.sort(flip_sign(minor), stable=True).indices
    return perm[torch.sort(flip_sign(major[perm]), stable=True).indices]


def legacy_barcode_histogram(records: torch.Tensor, max_uniques: int, bc16: bool):
    n = records.shape[0]
    if not bc16:
        sorted_bc = torch.sort(flip_sign(records[:, 0])).values ^ SIGN_BIT
    else:
        lo = ((records[:, 0] & _LO32) - _HALF32).to(torch.int32)
        sorted_bc = torch.sort(lo).values.to(torch.int64) + _HALF32
    starts, ends, num_unique = _group_bounds(_changed([sorted_bc]), max_uniques)
    counts = ends - starts
    keys = torch.where(counts > 0, sorted_bc[starts.clamp(max=n - 1)], 0)
    return keys, counts, num_unique


def legacy_sparse_group_sum(keys: torch.Tensor, weights: torch.Tensor, capacity: int):
    invalid = weights == 0
    perm = stable_argsort2(invalid.to(torch.int64), keys)
    keys, weights, invalid = keys[perm], weights[perm], invalid[perm]
    first = _changed([invalid]) | (_changed([keys]) & ~invalid)
    starts, ends, _ = _group_bounds(first, capacity)
    sums = _prefix(weights)
    counts = sums[ends] - sums[starts]
    out = torch.where(counts > 0, keys[starts.clamp(max=keys.shape[0] - 1)], 0)
    return out, counts, (first & ~invalid).sum()


def legacy_merged(parts, capacity: int, lane: int, device):
    keys, weights = to(device, np.concatenate([k for k, _ in parts]),
                       np.concatenate([c for _, c in parts]))
    out, counts, n = legacy_sparse_group_sum(keys, weights, capacity + lane)
    return (out[:capacity], counts[:capacity], n, out[capacity:], counts[capacity:],
            (n - capacity).clamp(min=0))
