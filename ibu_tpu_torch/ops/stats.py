"""Device statistics on ``(N, 3)`` int64 records: exact sums and the sort.

Counterpart of :mod:`ibu_tpu.ops.stats`. The JAX package sums through a
u16-limb pyramid because the TPU is 32-bit; here an exact mod-2^64 field sum
is a wrapping int64 sum. The record sort is stable least-significant-first
argsort passes over sign-flipped keys, in torch ops.
"""

from __future__ import annotations

import torch

from ibu_tpu_torch.ops.u64 import U64_MASK, flip_sign

_FIELDS = ("barcode", "umi", "index")
_LO32 = 0xFFFFFFFF


def field_sums(records: torch.Tensor) -> torch.Tensor:
    """Per-field wrapping sums of ``(N, 3)`` int64 records → ``(3,)`` int64,
    each the u64 field total mod 2^64 (as int64 bits)."""
    return records.sum(dim=0, dtype=torch.int64)


def checksum_records(records: torch.Tensor) -> tuple[int, int, int]:
    """Exact (barcode_sum, umi_sum, index_sum) mod 2^64 as Python ints."""
    return tuple(int(s) & U64_MASK for s in field_sums(records).tolist())


def _sort_impl(records: torch.Tensor, hi_used: tuple[bool, bool, bool]) -> torch.Tensor:
    """Sort by (barcode, umi, index) in unsigned order.

    A field whose hi word is dropped by a hint takes 32 key bits, a full
    field 64; neighbouring fields are packed into one int64 key while they
    fit (bc16 + umi12 + index is two keys, not three). Each key is sign
    flipped and sorted by a stable argsort, last key first. As in the JAX
    package, dropped hi words come back as zeros.
    """
    cols = [
        records[:, f] if hi_used[f] else records[:, f] & _LO32 for f in range(3)
    ]
    keys: list[torch.Tensor] = []
    key, bits = None, 0
    for f in range(3):
        width = 64 if hi_used[f] else 32
        if key is not None and bits + width <= 64:
            key, bits = (key << width) | cols[f], bits + width
        else:
            if key is not None:
                keys.append(key)
            key, bits = cols[f], width
    keys.append(key)
    perm = None
    for key in reversed(keys):
        k = key if perm is None else key[perm]
        order = torch.sort(flip_sign(k), stable=True).indices
        perm = order if perm is None else perm[order]
    return torch.stack(cols, dim=1)[perm]


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
    """
    hi_used = (
        bc_len is None or bc_len > 16,
        umi_len is None or umi_len > 16,
        index_bits is None or index_bits > 32,
    )
    if check and not all(hi_used):
        dropped = [f for f in range(3) if not hi_used[f]]
        nz = ((records[:, dropped] >> 32) != 0).any(dim=0).tolist()
        if any(nz):
            bad = [_FIELDS[f] for f, z in zip(dropped, nz) if z]
            raise ValueError(
                f"sort hint violated: {', '.join(bad)} hi word(s) contain "
                "nonzero bits; fix the bc_len/umi_len/index_bits hints"
            )
    return _sort_impl(records, hi_used)
