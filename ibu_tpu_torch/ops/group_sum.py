"""Group-by-key sums by compacted keys: CUDA for Hopper and its plain torch
version. The histogram engine's one group-by: a batch's barcode histogram is
this with unit weights, and the merge of the device table with the staged
batch tables is this with counts as weights.

The entries come as parts ``(keys, weights)``: 1-D int64 tensors (u64 bits),
the keys at any positive stride (a batch's barcode column ``records[:, 0]``
is read in place), the weights contiguous, or ``None`` in every part for unit
weights. A weight of 0 marks an empty entry. After the key mask, the valid
keys hold ``w_key`` bits and the weights ``w_cnt`` (the bit lengths of their
ORs over the valid entries), and ``w_inv`` is 1 where any entry is empty. The
key ``invalid << (w_key + w_cnt) | key << w_cnt | weight``, an empty entry's
key and weight zeroed, is lossless: equal keys are equal entries, and its
unsigned order puts every valid group, in ascending key order, before the one
group of empties. It is :mod:`ibu_tpu_torch.ops.sort_cuda`'s record key with
the fields (invalid, key, weight) in place of (barcode, umi, index), and the
record sort's passes sort it. The kernels live in
``ibu_tpu_torch/csrc/record_sort.cu``; the source note there says how the
segments are found in one kernel.

:func:`group_sum` launches passes up to the width the caller bounds without a
look at the data (``key_bits`` + ``count_bits`` + the validity bit): the
kernels work the width out from the ORs on the card, and a pass above it
returns at once, so nothing waits on the card. Given CPU tensors it runs
:func:`plain_group_sum`, which repeats the arithmetic (compact, sort the key
words, segment) in torch ops. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from ibu_tpu_torch.ops import _build
from ibu_tpu_torch.ops import sort_cuda as SC
from ibu_tpu_torch.ops.codec_cuda import _check_device, _raise_on, _stream
from ibu_tpu_torch.ops.u64 import U64_MASK, to_signed
from ibu_tpu_torch.utils import trace

#: most parts one launch reads (``kMaxRanges`` in the source); more are
#: joined into the last
MAX_PARTS = 64
#: the fields of the compacted key, most significant first, all unmasked
_ALL = (True, True, True)


def plan(key_bits: int, count_bits: int, weighted: bool) -> tuple[int, int]:
    """``(key words, 8-bit passes)`` of the bound a call launches to
    (:func:`ibu_tpu_torch.ops.sort_cuda.plan`, at least one word): the key's
    bits, and where weighted the weight's bits and the validity bit."""
    words, passes = SC.plan((key_bits, count_bits + 1 if weighted else 0))
    return max(1, words), passes


def _check_parts(parts) -> tuple[torch.device, bool]:
    if not parts:
        raise ValueError("group_sum needs at least one part")
    weighted = parts[0][1] is not None
    device = parts[0][0].device
    for keys, weights in parts:
        if keys.dtype != torch.int64 or keys.dim() != 1:
            raise ValueError(
                f"keys must be a 1-D torch.int64 tensor, got {keys.dim()}-D {keys.dtype}")
        if (weights is not None) != weighted:
            raise ValueError("weights must be given in every part or in none")
        if weights is not None:
            if weights.dtype != torch.int64 or weights.shape != keys.shape:
                raise ValueError("weights must be int64 and as long as their keys")
            _check_device(device, weights)
        _check_device(device, keys)
    return device, weighted


def _compact(parts, key_mask: int) -> torch.Tensor:
    """The entries as ``(N, 3)`` int64 rows ``(invalid, key, weight)``: the
    key masked, an empty entry's key and weight zeroed, weight 0 where the
    parts carry none."""
    keys = torch.cat([k for k, _ in parts]) & to_signed(key_mask)
    if parts[0][1] is None:
        zero = torch.zeros_like(keys)
        return torch.stack([zero, keys, zero], dim=1)
    weights = torch.cat([w for _, w in parts])
    invalid = weights == 0
    keys = torch.where(invalid, 0, keys)
    return torch.stack([invalid.to(torch.int64), keys, weights], dim=1)


def plain_group_sum(parts, n_slots: int, key_mask: int = U64_MASK):
    """Plain torch version of :func:`group_sum`: the compacted keys sorted as
    the record sort's plain version sorts records (their ORs, the key words,
    stable argsorts, the fields rebuilt), then the groups: boundaries where
    (invalid, key) changes, ids by a cumsum of the valid boundaries, sums by
    ``index_add_``."""
    _, weighted = _check_parts(parts)
    rows = SC.plain_sort_records(_compact(parts, key_mask), _ALL)
    invalid, keys = rows[:, 0] != 0, rows[:, 1]
    weights = rows[:, 2] if weighted else torch.ones_like(keys)
    out_keys = torch.zeros(n_slots, dtype=torch.int64, device=keys.device)
    out_sums = torch.zeros(n_slots, dtype=torch.int64, device=keys.device)
    if keys.shape[0] == 0:
        return out_keys, out_sums, torch.zeros((), dtype=torch.int64, device=keys.device)
    head = torch.ones(1, dtype=torch.bool, device=keys.device)
    brk = torch.cat([head, (invalid[1:] != invalid[:-1]) | (keys[1:] != keys[:-1])])
    starts = brk & ~invalid
    group = torch.cumsum(starts, 0) - 1
    kept = ~invalid & (group < n_slots)
    first = starts & kept
    out_keys[group[first]] = keys[first]
    out_sums.index_add_(0, group[kept], weights[kept])
    return out_keys, out_sums, starts.sum()


def _joined(parts) -> list:
    """At most :data:`MAX_PARTS` parts: the ones past the last slot joined
    into it."""
    if len(parts) <= MAX_PARTS:
        return list(parts)
    rest = parts[MAX_PARTS - 1:]
    keys = torch.cat([k for k, _ in rest])
    weights = None if rest[0][1] is None else torch.cat([w for _, w in rest])
    return [*parts[:MAX_PARTS - 1], (keys, weights)]


def group_sum(parts, n_slots: int, key_bits: int = 64, count_bits: int = 64,
              key_mask: int = U64_MASK):
    """``(keys, sums, n_distinct)`` of the entries of ``parts``: the first
    ``n_slots`` distinct valid keys (masked by ``key_mask``) in ascending
    unsigned order with their summed weights (mod 2^64), the tail zeroed,
    and the true count of distinct valid keys as a 0-d tensor (above
    ``n_slots`` the groups past the table were dropped).

    ``key_bits`` bounds the masked keys' width and ``count_bits`` the
    weights' (both without a look at the data); the passes launched cover
    that bound, and a bound below the data's width sorts wrongly."""
    device, weighted = _check_parts(parts)
    if device.type == "cpu":
        return plain_group_sum(parts, n_slots, key_mask)
    parts = _joined(parts)
    n = sum(k.shape[0] for k, _ in parts)
    out_keys = torch.empty(n_slots, dtype=torch.int64, device=device)
    out_sums = torch.empty(n_slots, dtype=torch.int64, device=device)
    n_distinct = torch.empty((), dtype=torch.int64, device=device)
    if n == 0:
        return out_keys.zero_(), out_sums.zero_(), n_distinct.zero_()
    keys = [k if k.stride(0) >= 1 else k.contiguous() for k, _ in parts]
    weights = [w.contiguous() for _, w in parts] if weighted else None
    words, passes = plan(key_bits, count_bits, weighted)
    lib = _build.load()
    size = lib.ibu_group_sum_scratch_bytes(n, words)
    if size < 0:
        raise ValueError(f"{n} entries are more than the group sum takes (2^31 - 1)")
    scratch = torch.empty(size, dtype=torch.uint8, device=device)
    r = len(parts)
    ptrs = ctypes.c_void_p * r
    lengths = (ctypes.c_int64 * r)(*(k.shape[0] for k in keys))
    strides = (ctypes.c_int64 * r)(*(k.stride(0) for k in keys))
    with torch.cuda.device(device):
        rc = lib.ibu_group_sum(
            r, ptrs(*(k.data_ptr() for k in keys)), strides,
            None if weights is None else ptrs(*(w.data_ptr() for w in weights)), lengths,
            key_mask & U64_MASK, words, passes, scratch.data_ptr(), out_keys.data_ptr(),
            out_sums.data_ptr(), n_slots, n_distinct.data_ptr(), _stream(device),
        )
    _raise_on(rc, "group_sum")
    trace.count("hist_sort_passes", passes)
    group_sum.launches += 1
    return out_keys, out_sums, n_distinct


group_sum.launches = 0
