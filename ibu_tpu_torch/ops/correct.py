"""Barcode error correction against an allowlist (Hamming distance ≤ 1).

Policy (shared with :mod:`ibu_tpu.ops.correct`):

* a barcode already in the allowlist is kept (**exact**);
* otherwise, if exactly ONE allowlist entry lies at Hamming distance 1 (one
  substituted base), the barcode is rewritten to it (**corrected**);
* otherwise (no neighbour, or several — ambiguous) the record is dropped.

Sequencing batches repeat barcodes heavily, so the search runs over the
batch's UNIQUE barcodes only (host ``np.unique``), and each unique probes
the sorted allowlist by binary search: one ``searchsorted`` for exact hits
and one over the ``3L`` single-substitution variants (``bc XOR (d << 2i)``
in the packed 2-bit domain, ``d ∈ {1,2,3}``).

:func:`np_correct_unique` is a copy of the JAX package's numpy path, the
oracle. :func:`torch_correct_unique` is the counterpart of its
``lax_correct_unique``: on CUDA the 64-bit integers are native, so one int64
path serves every length up to 32 after a sign flip
(:func:`ibu_tpu_torch.ops.u64.flip_sign`), with no u32 restriction and no
power-of-two padding.

Status codes: 0 = drop (unmatched or ambiguous), 1 = exact, 2 = corrected.
"""

from __future__ import annotations

import numpy as np
import torch

from ibu_tpu_torch.ops.u64 import flip_sign, to_device, to_host, u64_as_int64
from ibu_tpu_torch.utils.device import resolve_device

#: status codes shared by every implementation
DROP, EXACT, CORRECTED = 0, 1, 2


def variant_deltas(length: int, dtype=np.uint64) -> np.ndarray:
    """XOR deltas of all ``3 * length`` single-base substitutions.

    In the 2-bit packing (base ``i`` at bits ``2i``) substituting base ``i``
    XORs a nonzero 2-bit value ``d`` into that field; distinct ``(i, d)``
    yield distinct deltas, so variants of one barcode never collide.
    """
    if not 1 <= length <= 32:
        raise ValueError(f"barcode length {length} outside 1..=32")
    i = np.arange(length, dtype=dtype)
    d = np.arange(1, 4, dtype=dtype)
    return (d[:, None] << (2 * i)[None, :]).reshape(-1)


def np_correct_unique(
    uniq: np.ndarray, allow_sorted: np.ndarray, length: int
) -> tuple[np.ndarray, np.ndarray]:
    """Correct UNIQUE packed barcodes against a sorted allowlist (numpy).

    Returns ``(corrected_values, status)`` aligned with ``uniq``; dropped
    entries keep their original value with status ``DROP``.
    """
    uniq = np.asarray(uniq, dtype=np.uint64)
    allow_sorted = np.asarray(allow_sorted, dtype=np.uint64)
    k = len(allow_sorted)
    out = uniq.copy()
    status = np.zeros(len(uniq), dtype=np.uint8)
    if k == 0 or len(uniq) == 0:
        return out, status
    pos = np.searchsorted(allow_sorted, uniq)
    exact = (pos < k) & (allow_sorted[np.minimum(pos, k - 1)] == uniq)
    status[exact] = EXACT

    miss = ~exact
    if miss.any():
        var = uniq[miss, None] ^ variant_deltas(length)[None, :]  # (M, 3L)
        vpos = np.searchsorted(allow_sorted, var.reshape(-1))
        hit = (vpos < k) & (
            allow_sorted[np.minimum(vpos, k - 1)] == var.reshape(-1)
        )
        hit = hit.reshape(var.shape)
        nhits = hit.sum(axis=1)
        one = nhits == 1
        # the unique hit's column; rows with one==False are ignored
        col = hit.argmax(axis=1)
        fixed = var[np.arange(len(var)), col]
        midx = np.flatnonzero(miss)
        out[midx[one]] = fixed[one]
        status[midx[one]] = CORRECTED
    return out, status


def _members(allow: torch.Tensor, probe: torch.Tensor) -> torch.Tensor:
    """Whether each ``probe`` value occurs in the ascending ``allow`` (both
    sign flipped int64)."""
    pos = torch.searchsorted(allow, probe).clamp(max=allow.shape[0] - 1)
    return allow[pos] == probe


def torch_correct_unique(
    uniq: torch.Tensor, allow_sorted: torch.Tensor, length: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`np_correct_unique` on int64 tensors holding u64 bits, on their
    device: ``(corrected, status)``, int64 and uint8, aligned with ``uniq``.

    Both sides are sign flipped, so int64 order is the unsigned order and
    ``allow_sorted`` (ascending unsigned) stays sorted; a variant of a
    flipped word is the flipped variant (XOR commutes). One ``searchsorted``
    finds the exact hits and one the hits of the ``(U, 3L)`` variant matrix.
    """
    deltas = to_device(u64_as_int64(variant_deltas(length)), uniq.device)
    if allow_sorted.shape[0] == 0 or uniq.shape[0] == 0:
        return uniq.clone(), torch.zeros(uniq.shape[0], dtype=torch.uint8, device=uniq.device)
    allow = flip_sign(allow_sorted)
    flipped = flip_sign(uniq)
    exact = _members(allow, flipped)
    var = flipped[:, None] ^ deltas  # (U, 3L)
    hit = _members(allow, var.reshape(-1)).reshape(var.shape)
    one = ~exact & (hit.sum(dim=1) == 1)
    # the unique hit's column; rows with one == False are ignored
    col = hit.to(torch.uint8).argmax(dim=1)
    fixed = flip_sign(var.gather(1, col[:, None])[:, 0])
    # no boolean-mask stores: they wait on the device for the mask's count
    status = exact.to(torch.uint8) * EXACT + one.to(torch.uint8) * CORRECTED
    return torch.where(one, fixed, uniq), status


def correct_batch(
    barcodes: np.ndarray,
    allow_sorted: np.ndarray,
    length: int,
    device: str | torch.device | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Correct a full barcode column: ``np.unique`` on the host, the probe
    (:func:`torch_correct_unique`) on ``device``, the inverse map back on the
    host.

    Returns ``(corrected_barcodes, status)`` aligned with ``barcodes``
    (dropped entries keep their value, status ``DROP``): the answers of
    :func:`np_correct_unique` for every length and every value.
    """
    device = resolve_device(device)
    barcodes = np.asarray(barcodes, dtype=np.uint64)
    allow_sorted = np.asarray(allow_sorted, dtype=np.uint64)
    uniq, inverse = np.unique(barcodes, return_inverse=True)
    fixed, status = torch_correct_unique(
        to_device(u64_as_int64(uniq), device),
        to_device(u64_as_int64(allow_sorted), device),
        length,
    )
    return to_host(fixed).view(np.uint64)[inverse], to_host(status)[inverse]
