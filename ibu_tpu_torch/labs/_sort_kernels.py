"""The radix-sort lab's CUDA kernels: wrappers and their plain torch versions.

The kernels live in ``ibu_tpu_torch/csrc/sort_lab.cu`` (built with the other
kernels by :mod:`ibu_tpu_torch.ops._build`); its source note says how each is
laid out on the card. Keys are u32 bit patterns held as an ``(n,)`` int32
tensor, cut into tiles of :data:`TILE` = 2048 keys (16 rows of 128); a key's
digit is its low byte. ``n`` must be a multiple of ``TILE * GROUP`` = 16384,
as in ``tools/pallas_sort_lab.py`` (whose grid takes :data:`GROUP` tiles per
step); a wrapper raises ``ValueError`` otherwise.

- :func:`digit_histogram`: ``(n,)`` → ``(n / 2048, 256)`` per-tile digit
  counts;
- :func:`rank_cumsum`: ``(n,)`` → ``(n / 128, 128)``, each key's stable rank
  among the keys of its tile with the same digit, in row-major order;
- :func:`dynamic_store`: keys and ``(n / 2048 * 8, 128)`` offset rows →
  ``(n / 128, 128)``: per tile, 256 stores in order ``c = 0..255`` of key
  rows ``[8 (c % 2), 8 (c % 2) + 8)`` to output rows ``[off_c, off_c + 8)``
  of the tile's 16-row block, ``off_c = offs[8 t + c // 128, c % 128]``; a
  later store overwrites an earlier one, rows no store covers are 0, and a
  store whose offset lies outside ``[0, 8]`` is skipped.

As in :mod:`ibu_tpu_torch.ops.codec_cuda`, a wrapper given CUDA tensors
launches its kernel on the current stream and raises if the launch fails
(``ValueError`` for a CUDA tensor that does not start at a 16-byte boundary);
given CPU tensors it runs the plain version beside it, with no fallback from
one to the other. Each wrapper counts its launches in ``launches``.
"""

from __future__ import annotations

import torch

from ibu_tpu_torch.ops import _build
from ibu_tpu_torch.ops.codec_cuda import _check_device, _check_tensor, _raise_on, _stream

ROWS, LANES = 16, 128
TILE = ROWS * LANES
GROUP = 8
DIGITS = 256
#: rows of 128 offsets per tile in ``dynamic_store``'s offset array (the
#: first two hold the tile's 256 offsets, the rest are padding)
OFF_ROWS = 8
#: the largest offset of an 8-row store into a 16-row block
MAX_OFFSET = ROWS - 8
KEYS_MULTIPLE = TILE * GROUP


def _check_keys(keys: torch.Tensor) -> int:
    """Check the keys; returns their tile count."""
    _check_tensor(keys, "keys", torch.int32, 1)
    n = keys.shape[0]
    if n % KEYS_MULTIPLE:
        raise ValueError(
            f"keys hold {n} keys; the sort lab takes a multiple of {KEYS_MULTIPLE} "
            f"({GROUP} tiles of {TILE})"
        )
    _check_device(keys.device)
    return n // TILE


def _check_offsets(offs: torch.Tensor, keys: torch.Tensor, tiles: int) -> None:
    _check_tensor(offs, "offs", torch.int32, 2)
    if tuple(offs.shape) != (tiles * OFF_ROWS, LANES):
        raise ValueError(f"offs must be ({tiles * OFF_ROWS}, {LANES}) for {tiles} tiles, "
                         f"got {tuple(offs.shape)}")
    _check_device(keys.device, offs)


def _launch(kernel, entry: str, tiles: int, *tensors: torch.Tensor) -> None:
    device = tensors[0].device
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{kernel.__name__} reads 16-byte vectors: every tensor must start "
                         "at a 16-byte boundary")
    lib = _build.load()
    with torch.cuda.device(device):
        rc = getattr(lib, entry)(*(t.data_ptr() for t in tensors), tiles, _stream(device))
    _raise_on(rc, kernel.__name__)
    kernel.launches += 1


def _tile_digits(keys: torch.Tensor) -> torch.Tensor:
    """``tile * 256 + digit`` of every key, int64."""
    tiles = keys.shape[0] // TILE
    base = torch.arange(tiles, dtype=torch.int64, device=keys.device) * DIGITS
    return ((keys & 0xFF).to(torch.int64).view(tiles, TILE) + base[:, None]).reshape(-1)


# ---------------------------------------------------------------------------
# plain torch versions
# ---------------------------------------------------------------------------


def plain_digit_histogram(keys: torch.Tensor) -> torch.Tensor:
    """Plain torch version of :func:`digit_histogram`: a scatter-add of ones
    at ``tile * 256 + digit``."""
    tiles = keys.shape[0] // TILE
    hist = torch.zeros(tiles * DIGITS, dtype=torch.int32, device=keys.device)
    hist.scatter_add_(0, _tile_digits(keys), torch.ones_like(keys))
    return hist.view(tiles, DIGITS)


def plain_rank_cumsum(keys: torch.Tensor) -> torch.Tensor:
    """Plain torch version of :func:`rank_cumsum`: a stable sort by
    ``tile * 256 + digit``; a key's rank is its place in the sorted order
    less the place where its group starts."""
    n = keys.shape[0]
    group = _tile_digits(keys)
    ordered, order = torch.sort(group, stable=True)
    start = torch.searchsorted(ordered, ordered)
    rank = torch.empty(n, dtype=torch.int64, device=keys.device)
    rank.scatter_(0, order, torch.arange(n, device=keys.device) - start)
    return rank.to(torch.int32).view(n // LANES, LANES)


def plain_dynamic_store(keys: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """Plain torch version of :func:`dynamic_store`: the 256 stores in order,
    each over every tile at once."""
    tiles = keys.shape[0] // TILE
    src = keys.view(tiles, ROWS, LANES)
    off = offs.view(tiles, OFF_ROWS * LANES)[:, :DIGITS].to(torch.int64)
    out = torch.zeros((tiles, ROWS, LANES), dtype=torch.int32, device=keys.device)
    rows8 = torch.arange(8, device=keys.device)
    for c in range(DIGITS):
        start = off[:, c]
        inside = ((start >= 0) & (start <= MAX_OFFSET))[:, None, None]
        dest = (start.clamp(0, MAX_OFFSET)[:, None] + rows8)[:, :, None].expand(-1, -1, LANES)
        g = c % (ROWS // 8)
        # a skipped store writes back what the rows already hold
        out.scatter_(1, dest, torch.where(inside, src[:, 8 * g:8 * g + 8], out.gather(1, dest)))
    return out.view(tiles * ROWS, LANES)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def digit_histogram(keys: torch.Tensor) -> torch.Tensor:
    """``(n,)`` int32 keys → ``(n / 2048, 256)`` int32: ``out[t, c]`` counts
    the keys of tile ``t`` whose low byte is ``c``."""
    tiles = _check_keys(keys)
    if keys.device.type == "cpu":
        return plain_digit_histogram(keys)
    hist = torch.empty((tiles, DIGITS), dtype=torch.int32, device=keys.device)
    if tiles:
        _launch(digit_histogram, "ibu_lab_digit_histogram", tiles, keys, hist)
    return hist


digit_histogram.launches = 0


def rank_cumsum(keys: torch.Tensor) -> torch.Tensor:
    """``(n,)`` int32 keys → ``(n / 128, 128)`` int32: each key's number of
    earlier keys (row-major) in its tile with the same low byte."""
    tiles = _check_keys(keys)
    if keys.device.type == "cpu":
        return plain_rank_cumsum(keys)
    rank = torch.empty((tiles * ROWS, LANES), dtype=torch.int32, device=keys.device)
    if tiles:
        _launch(rank_cumsum, "ibu_lab_rank_cumsum", tiles, keys, rank)
    return rank


rank_cumsum.launches = 0


def dynamic_store(keys: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """``(n,)`` int32 keys and ``(n / 2048 * 8, 128)`` int32 offset rows →
    ``(n / 128, 128)`` int32: each tile's 256 eight-row stores, in order
    (see the module note)."""
    tiles = _check_keys(keys)
    _check_offsets(offs, keys, tiles)
    if keys.device.type == "cpu":
        return plain_dynamic_store(keys, offs)
    out = torch.empty((tiles * ROWS, LANES), dtype=torch.int32, device=keys.device)
    if tiles:
        _launch(dynamic_store, "ibu_lab_dynamic_store", tiles, keys, offs, out)
    return out


dynamic_store.launches = 0

#: every sort-lab wrapper, with its plain version and the TPU kernel it replaces
KERNELS = {
    "digit_histogram": (digit_histogram, plain_digit_histogram, "tools/pallas_sort_lab.py:88"),
    "rank_cumsum": (rank_cumsum, plain_rank_cumsum, "tools/pallas_sort_lab.py:141"),
    "dynamic_store": (dynamic_store, plain_dynamic_store, "tools/pallas_sort_lab.py:173"),
}
