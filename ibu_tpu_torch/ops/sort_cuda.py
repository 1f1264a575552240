"""The record sort by bit-compacted keys: CUDA for Hopper and its plain torch
version.

A record's fields, after the hint masks (the lo 32 bits of a field whose hi
word a hint dropped), hold ``w`` bits each, ``w`` the bit length of the
field's OR over the batch. The key ``barcode << (w_umi + w_idx) | umi << w_idx
| index`` of ``W = w_bc + w_umi + w_idx`` bits is lossless, and its unsigned
order is the records' (barcode, umi, index) order; it is held least
significant word first in ``ceil(W / 64)`` u64 words. Sorting the keys alone
and rebuilding the records from them sorts the records: no index payload, no
gather. The kernels live in ``ibu_tpu_torch/csrc/record_sort.cu`` (built by
:mod:`ibu_tpu_torch.ops._build`); the source note there says what bounds them
on the card and how they are laid out.

:func:`sort_records` launches ``ceil(W / 8)`` passes of 8-bit digits where
the caller has read the ORs on the host (:class:`Hints` carries them), and
otherwise passes up to the width the hints bound (32 bits a dropped field, 64
otherwise): the kernels work ``W`` out from the ORs on the card, and a pass
above it returns at once, so nothing waits on the card.

A wrapper given CUDA tensors launches its kernels on the current stream and
raises if a launch fails; given CPU tensors it runs the plain version beside
it, which repeats the arithmetic (compact, sort the word keys, rebuild) in
torch ops. There is no fallback from one to the other. Each wrapper counts
its calls into the library in its ``launches`` attribute.
"""

from __future__ import annotations

import torch

from ibu_tpu_torch.ops import _build
from ibu_tpu_torch.ops.codec_cuda import _check_device, _check_tensor, _raise_on, _stream
from ibu_tpu_torch.ops.u64 import U64_MASK, flip_sign, to_signed

_LO32 = 0xFFFFFFFF


class Hints(tuple):
    """Per field (barcode, umi, index), whether its hi word takes part in
    the key (False where a hint dropped it); where the caller has read the
    batch's field ORs, ``ors`` is their ``(3,)`` tensor (:func:`field_ors`)
    and ``widths`` each field's key width worked out from them on the host
    (:func:`key_widths`). Both are None otherwise."""

    ors: torch.Tensor | None = None
    widths: tuple[int, int, int] | None = None

    def __new__(cls, hi_used, ors: torch.Tensor | None = None,
                widths: tuple[int, int, int] | None = None):
        self = super().__new__(cls, (bool(h) for h in hi_used))
        self.ors, self.widths = ors, widths
        return self


def masks(hi_used) -> tuple[int, int, int]:
    """Each field's hint mask as a u64: the lo word alone where a hint
    dropped the hi word."""
    return tuple(U64_MASK if h else _LO32 for h in hi_used)


def key_widths(ors, hi_used) -> tuple[int, int, int]:
    """Each field's key width: the bit length of its OR (int64 bits or an
    unsigned int) after the hint mask; 0 for a field that is all zero."""
    return tuple((o & m).bit_length() for o, m in zip(ors, masks(hi_used)))


def bound_widths(hi_used) -> tuple[int, int, int]:
    """The widths the hints bound without a look at the data: 32 bits a
    dropped field, 64 otherwise."""
    return tuple(64 if h else 32 for h in hi_used)


def plan(widths) -> tuple[int, int]:
    """``(key words, 8-bit passes)`` of a key of the fields' ``widths``:
    ``ceil(W / 64)`` and ``ceil(W / 8)`` for ``W = sum(widths)``."""
    bits = sum(widths)
    return -(-bits // 64), -(-bits // 8)


def launch_widths(hints: Hints) -> tuple[int, int, int]:
    """The widths :func:`sort_records` sizes the key and its passes by:
    the exact ones where the caller read the ORs, else the hints' bound."""
    return hints.widths if hints.widths is not None else bound_widths(hints)


def _offsets(widths) -> tuple[int, int, int]:
    """Each field's lowest bit in the key: the index lowest, the barcode
    highest."""
    w_bc, w_umi, w_idx = widths
    return w_idx + w_umi, w_idx, 0


def _check_records(records: torch.Tensor) -> None:
    _check_tensor(records, "records", torch.int64, 2)
    if records.shape[1] != 3:
        raise ValueError(f"records must be (N, 3), got {tuple(records.shape)}")
    _check_device(records.device)


# ---------------------------------------------------------------------------
# plain torch versions, on int64 bits
# ---------------------------------------------------------------------------


def _shr(v: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits by ``s`` in ``0..63``."""
    return v if s == 0 else (v >> s) & ((1 << (64 - s)) - 1)


def _low_bits(v: torch.Tensor, width: int) -> torch.Tensor:
    return v if width == 64 else v & ((1 << width) - 1)


def _put(words: list[torch.Tensor], v: torch.Tensor, offset: int, width: int) -> None:
    """Or ``v`` (no bits at or above ``width``) into the key words at bit
    ``offset``; int64 left shifts wrap as u64 shifts do."""
    if width == 0:
        return
    q, s = divmod(offset, 64)
    words[q] |= v << s
    if s and s + width > 64:
        words[q + 1] |= _shr(v, 64 - s)


def _get(words: list[torch.Tensor], offset: int, width: int) -> torch.Tensor:
    """The ``width`` bits of the key words at bit ``offset``."""
    if width == 0:
        return torch.zeros_like(words[0])
    q, s = divmod(offset, 64)
    v = _shr(words[q], s)
    if s and s + width > 64:
        v = v | words[q + 1] << (64 - s)
    return _low_bits(v, width)


def plain_field_ors(records: torch.Tensor) -> torch.Tensor:
    """Plain torch version of :func:`field_ors`: halves ORed together until
    one row is left (a row ORed with itself evens an odd count)."""
    x = records
    if x.shape[0] == 0:
        return torch.zeros(3, dtype=torch.int64, device=records.device)
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = torch.cat([x, x[-1:]])
        x = x[0::2] | x[1::2]
    return x[0].clone()


def plain_pack(records: torch.Tensor, hi_used, widths) -> list[torch.Tensor]:
    """The key words of ``(N, 3)`` records for the fields' ``widths``, least
    significant first, as int64 bits (no words where ``W`` is 0)."""
    n_words, _ = plan(widths)
    fields = [records[:, f] & to_signed(m) for f, m in enumerate(masks(hi_used))]
    offsets = _offsets(widths)
    words = [torch.zeros_like(fields[0]) for _ in range(n_words)]
    for f in range(3):
        _put(words, fields[f], offsets[f], widths[f])
    return words


def plain_sort_records(records: torch.Tensor, hi_used, ors: torch.Tensor | None = None,
                       widths=None) -> torch.Tensor:
    """Plain torch version of :func:`sort_records`: the key words, their
    unsigned order by stable argsorts (least significant word first), and
    the records rebuilt from the sorted words."""
    if widths is None:
        ors = plain_field_ors(records) if ors is None else ors
        widths = key_widths(ors.tolist(), hi_used)
    words = plain_pack(records, hi_used, widths)
    if not words:
        return torch.zeros_like(records)
    offsets = _offsets(widths)
    perm = None
    for w in words:
        key = w if perm is None else w[perm]
        order = torch.sort(flip_sign(key), stable=True).indices
        perm = order if perm is None else perm[order]
    words = [w[perm] for w in words]
    return torch.stack([_get(words, offsets[f], widths[f]) for f in range(3)], dim=1)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def field_ors(records: torch.Tensor) -> torch.Tensor:
    """The OR of each field of ``(N, 3)`` int64 records over the batch:
    ``(3,)`` int64 (u64 bits), zeros for no records."""
    _check_records(records)
    device = records.device
    if device.type == "cpu":
        return plain_field_ors(records)
    n = records.shape[0]
    if n == 0:
        return torch.zeros(3, dtype=torch.int64, device=device)
    ors = torch.empty(3, dtype=torch.int64, device=device)
    lib = _build.load()
    with torch.cuda.device(device):
        rc = lib.ibu_field_ors(records.data_ptr(), n, ors.data_ptr(), _stream(device))
    _raise_on(rc, "field_ors")
    field_ors.launches += 1
    return ors


field_ors.launches = 0


def sort_records(records: torch.Tensor, hints: Hints) -> torch.Tensor:
    """``(N, 3)`` int64 records in unsigned (barcode, umi, index) order, the
    hi words that ``hints`` drops zeroed, as a new contiguous tensor.

    The key is sized by :func:`launch_widths`; the ORs are ``hints.ors``
    where the caller read them, else :func:`field_ors` of ``records``."""
    _check_records(records)
    device = records.device
    if hints.ors is not None:
        _check_tensor(hints.ors, "ors", torch.int64, 1)
        _check_device(device, hints.ors)
    if device.type == "cpu":
        return plain_sort_records(records, hints, hints.ors, hints.widths)
    n = records.shape[0]
    out = torch.empty((n, 3), dtype=torch.int64, device=device)
    if n == 0:
        return out
    ors = field_ors(records) if hints.ors is None else hints.ors
    n_words, passes = plan(launch_widths(hints))
    n_words = max(n_words, 1)
    lib = _build.load()
    size = lib.ibu_record_sort_scratch_bytes(n, n_words)
    if size < 0:
        raise ValueError(f"{n} records are more than the record sort takes (2^31 - 1)")
    scratch = torch.empty(size, dtype=torch.uint8, device=device)
    with torch.cuda.device(device):
        rc = lib.ibu_record_sort(
            records.data_ptr(), n, ors.data_ptr(), *masks(hints), n_words, passes,
            scratch.data_ptr(), out.data_ptr(), _stream(device),
        )
    _raise_on(rc, "record_sort")
    sort_records.launches += 1
    return out


sort_records.launches = 0
