"""The device record layout and the conversions at its boundary.

Records live on the device in the wire layout: a ``(N, 3)`` int64 tensor with
columns ``[barcode, umi, index]``, each holding the bits of the record's
little-endian u64 field. It is a zero-copy ``view(np.int64)`` of
``RECORD_DTYPE`` arrays, so moving records between the file, the host and the
device never rearranges bytes.

int64 is the device dtype because CUDA covers it fully; unsigned u64 order is
int64 order after flipping bit 63 (:func:`flip_sign`), and an exact mod-2^64
sum is a wrapping int64 sum.

The ``*_jax_*`` converters translate the JAX package's ``(6, N)`` uint32
lo/hi column matrix, its limb-sum statistics state and its device histogram
table into this layout, so a record batch or a running state carries across
from one package to the other.
"""

from __future__ import annotations

import numpy as np
import torch

from ibu_tpu_torch.constructs.record import RECORD_DTYPE
from ibu_tpu_torch.utils import trace

U64_MASK = (1 << 64) - 1
#: int64 with only bit 63 set.
SIGN_BIT = -(1 << 63)

_TORCH_DTYPE = {
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int64): torch.int64,
}


def wire_view(records: np.ndarray) -> np.ndarray:
    """Structured record array → ``(N, 3)`` int64 view of the same bytes."""
    if records.dtype != RECORD_DTYPE:
        raise ValueError(f"expected dtype {RECORD_DTYPE}, got {records.dtype}")
    return np.ascontiguousarray(records).view(np.int64).reshape(-1, 3)


def host_tensor(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor over ``arr``, copying only when numpy's array is
    read-only (an mmap view), which ``torch.from_numpy`` does not accept."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr)


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array → tensor on ``device``. A CUDA target gets the bytes
    through a pinned staging buffer and an asynchronous copy on the current
    stream (the caching host allocator keeps the buffer until the copy ends).

    >>> t = to_device(np.arange(3, dtype=np.int64), torch.device("cpu"))
    >>> (t.tolist(), t.dtype)
    ([0, 1, 2], torch.int64)
    """
    if device.type == "cpu":
        return host_tensor(arr)
    arr = np.ascontiguousarray(arr)
    with trace.span("h2d.pinned_alloc"):
        staged = torch.empty(arr.shape, dtype=_TORCH_DTYPE[arr.dtype], pin_memory=True)
    with trace.span("h2d.stage"):
        trace.count("staged_bytes", arr.nbytes)
        staged.numpy()[...] = arr
    trace.count("h2d_bytes", arr.nbytes)
    return staged.to(device, non_blocking=True)


def to_host(t: torch.Tensor) -> np.ndarray:
    """Tensor → numpy array on the host. From a card the bytes land in a
    pinned buffer that the returned array keeps alive: a copy into fresh
    pageable memory ran at about 2.3 GB/s on an H100 host, one into pinned
    memory at link speed.

    >>> to_host(torch.tensor([[1, -1]])).tolist()
    [[1, -1]]
    """
    t = t.detach().contiguous()
    if t.device.type == "cpu":
        return t.numpy()
    with trace.span("h2d.pinned_alloc"):
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    with trace.span("d2h.wait"):
        trace.count("d2h_bytes", out.numel() * out.element_size())
        out.copy_(t)
    return out.numpy()


def records_to_tensor(records: np.ndarray, device: torch.device) -> torch.Tensor:
    """Structured records → ``(N, 3)`` int64 tensor on ``device``.

    >>> from ibu_tpu_torch.constructs.record import make_records
    >>> recs = make_records(np.array([1, 2**64 - 1], dtype=np.uint64),
    ...                     np.array([2, 5], dtype=np.uint64),
    ...                     np.array([3, 6], dtype=np.uint64))
    >>> t = records_to_tensor(recs, torch.device("cpu"))
    >>> (tuple(t.shape), t.dtype, t[1].tolist())  # u64 max is int64 -1
    ((2, 3), torch.int64, [-1, 5, 6])
    >>> records_from_tensor(t).tobytes() == recs.tobytes()
    True
    """
    return to_device(wire_view(records), device)


def records_from_tensor(records: torch.Tensor) -> np.ndarray:
    """``(N, 3)`` int64 tensor → structured record array on the host."""
    return to_host(records).view(RECORD_DTYPE).reshape(-1)


def u64_as_int64(words: np.ndarray) -> np.ndarray:
    """uint64 array → int64 view of the same bits."""
    return np.ascontiguousarray(words, dtype=np.uint64).view(np.int64)


def flip_sign(x: torch.Tensor) -> torch.Tensor:
    """u64 bits held in int64 → int64 whose signed order is the unsigned order."""
    return x ^ SIGN_BIT


def to_signed(v: int) -> int:
    """Python int taken mod 2^64 → the int64 with the same bits."""
    v &= U64_MASK
    return v - (1 << 64) if v >> 63 else v


# ---------------------------------------------------------------------------
# converters from and to the JAX package's device state
# ---------------------------------------------------------------------------


def records_from_jax_soa(soa: np.ndarray) -> torch.Tensor:
    """``(6, N)`` uint32 column matrix ``[bc_lo, bc_hi, umi_lo, umi_hi,
    idx_lo, idx_hi]`` → ``(N, 3)`` int64 records (CPU)."""
    soa = np.asarray(soa)
    if soa.ndim != 2 or soa.shape[0] != 6 or soa.dtype != np.uint32:
        raise ValueError(f"expected (6, N) uint32, got {soa.shape} {soa.dtype}")
    return torch.from_numpy(np.ascontiguousarray(soa.T).view(np.int64).copy())


def jax_soa_from_records(records: torch.Tensor) -> np.ndarray:
    """``(N, 3)`` int64 records → ``(6, N)`` uint32 column matrix."""
    host = records.detach().cpu().contiguous().numpy()
    return np.ascontiguousarray(host.view(np.uint32).reshape(-1, 6).T)


def fold_limbs(level2) -> int:
    """A ``(4, 2)`` u16-limb sum (the JAX package's exact-sum state for one
    field) → the exact mod-2^64 total."""
    level2 = np.asarray(level2, dtype=np.uint64)
    total = 0
    for k in range(4):
        limb_total = int(level2[k, 1]) * 65536 + int(level2[k, 0])
        total += limb_total << (16 * k)
    return total & U64_MASK


def stats_state_from_jax(state: dict, shard: int | None = None) -> dict:
    """The JAX package's merged statistics state ``{count, count_hi, sums
    (3, 4, 2) uint32 limbs}`` → this package's ``{count, sums (3,) int64}``
    (CPU tensors), holding the same record count and mod-2^64 sums.

    ``shard=s`` takes shard ``s`` of a per-shard state stacked ``(S, ...)``
    (the JAX package's ``MapReduce`` states before ``finalize``), the state
    that seeds rank ``s`` of a cohort: the ranks' merge then equals the JAX
    package's."""
    if shard is not None:
        state = {k: np.asarray(v)[shard] for k, v in state.items()}
    count = int(state["count"]) + (int(state["count_hi"]) << 32)
    sums = np.asarray(state["sums"])
    return {
        "count": torch.tensor(count, dtype=torch.int64),
        "sums": torch.tensor(
            [to_signed(fold_limbs(sums[f])) for f in range(3)], dtype=torch.int64
        ),
    }


def histogram_state_from_jax(state: dict, shard: int | None = None) -> dict:
    """The JAX package's ``DeviceHistogram._state`` (``lo``/``hi``/``cnt``
    uint32 tables, ``n``, ``shard_seen``; its stage must be merged) → the
    table state ``{keys, cnt, n, shard_seen}`` (int64 CPU tensors) that
    :meth:`ibu_tpu_torch.parallel.device.DeviceHistogram.resume` continues
    from.

    The JAX table is replicated over its shards (merged on the device), so
    ``shard=s`` seeds rank ``s`` of a cohort: shard 0 takes the table, every
    other shard an empty table of the same capacity, and the ranks' merge
    equals the JAX package's table."""
    if np.asarray(state["st_cnt"]).any():
        raise ValueError("the histogram state has staged batches; merge them first")
    if shard:
        state = {**state, **{k: np.zeros_like(np.asarray(state[k])) for k in ("lo", "hi", "cnt")}}
    lo = np.asarray(state["lo"], dtype=np.uint32).astype(np.uint64)
    hi = np.asarray(state["hi"], dtype=np.uint32).astype(np.uint64)
    return {
        "keys": torch.from_numpy((lo | hi << np.uint64(32)).view(np.int64)),
        "cnt": torch.from_numpy(np.asarray(state["cnt"], dtype=np.uint32).astype(np.int64)),
        "n": torch.tensor(int(state["n"]), dtype=torch.int64),
        "shard_seen": torch.tensor(int(state["shard_seen"]), dtype=torch.int64),
    }
