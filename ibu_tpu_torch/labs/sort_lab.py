"""Radix-sort lab for the H100: can radix-sort ingredients beat the built-in sort?

    python -m ibu_tpu_torch.labs.sort_lab [--records N] [--runs R]
    python -m ibu_tpu_torch.labs.sort_lab --device cpu --records 32768

The Hopper counterpart of ``tools/pallas_sort_lab.py``. An 8-bit-digit LSD
radix sort of u32 keys takes 4 passes, and each pass must (a) compute every
key's destination rank and (b) move each key to a data-dependent place. The
lab times each ingredient as a kernel of its own
(:mod:`ibu_tpu_torch.labs._sort_kernels`, ``csrc/sort_lab.cu``), because the
composition can never beat its slowest part:

- K1 ``digit_histogram``: per-tile 256-bin digit counts, the counting phase
  every radix formulation shares;
- K2 ``rank_cumsum``: each key's stable rank among the keys of its tile with
  the same digit;
- K3 ``dynamic_store``: 256 eight-row stores per tile at data-dependent
  offsets, in order, the move phase at the TPU lab's granularity. On this
  card the kernel does not make the stores: it finds, once per tile, the
  last store that covers each of the 16 output rows
  (:func:`np_last_writers` states it in numpy) and copies whole key rows, so
  it reads only the key rows the offsets select.

The yardsticks are ``torch.sort`` of the keys in unsigned order (one key,
the TPU lab's ``lax.sort`` 1-op) and the three-key lexicographic sort
``(x, (x * 40503) & 0xFFFFFF, iota)`` through the port's production route,
the record sort (:func:`ibu_tpu_torch.ops.sort_cuda.sort_records`, its three
hi words dropped), in place of the TPU lab's ``lax.sort`` 3-op. ``torch.sort``
is a yardstick only, never a port of any kernel.

Keys are made on the device, key ``i`` of seed ``s`` being
``((i * 2654435761) ^ (i >> 3) ^ s) mod 2^32``: seed 0 for the checks, seeds
100, 101, 102 for the timed runs. K3's offsets are
``default_rng(0).permutation(tiles * 256) % 9``. Each kernel is checked
exactly against numpy oracles over every key (``bincount``; a stable
argsort rank, and on the first tile the sequential count of the TPU lab;
the stores in order) before anything is timed; a failed check exits 1.
Times are CUDA events over the 3 timed key sets, runs interleaved after an
untimed warm-up (:func:`ibu_tpu_torch.labs._harness.time_interleaved`).
Each row's bound is the bytes the function must move over the H100's
3350 GB/s; K3's counts the key rows its offsets select. The verdict line
gives the per-pass floor ``max(K2, K3)``, the 4-pass radix time it implies,
and its ratio to the one-key sort. It is a lower bound on a radix sort: a
pass also needs the global offset scan and the scattered move of every key,
which no kernel here times. Without a CUDA card the lab exits 2 unless given
``--device cpu``, which runs the plain versions through the checks and
prints no timing.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ibu_tpu_torch.labs import _harness as H
from ibu_tpu_torch.labs import _sort_kernels as K
from ibu_tpu_torch.ops import sort_cuda
from ibu_tpu_torch.utils.device import select_device

DEFAULT_KEYS = 1 << 24
CHECK_SEED = 0
TIMED_SEEDS = (100, 101, 102)
HASH = 2654435761
UMI_MULT = 40503
SIGN32 = -(1 << 31)
KERNEL_ROWS = ("K1 digit_histogram", "K2 rank_cumsum", "K3 dynamic_store")
SORT1, SORT3 = "torch.sort 1-key", "3-key sort (production)"


def make_keys(n: int, seed: int, device: torch.device) -> torch.Tensor:
    """``(n,)`` int32 keys of the lab formula, made on ``device``."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    x = ((i * HASH) ^ (i >> 3) ^ seed) & 0xFFFFFFFF
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def make_offsets(tiles: int) -> np.ndarray:
    """K3's ``(tiles * 8, 128)`` int32 offset rows: tile ``t``'s 256 offsets
    in rows ``[8t, 8t + 2)``, the rest zero padding
    (``tools/pallas_sort_lab.py:269-273``)."""
    offs = (np.random.default_rng(0).permutation(tiles * K.DIGITS)
            % (K.MAX_OFFSET + 1)).reshape(tiles, K.DIGITS).astype(np.int32)
    pad = np.zeros((tiles * K.OFF_ROWS, K.LANES), np.int32)
    pad.reshape(tiles, K.OFF_ROWS * K.LANES)[:, :K.DIGITS] = offs
    return pad


#: K2 key cases that stress the rank kernel: ranks up to 2047 with one
#: warp's count at 512, every digit exactly 8 times in every tile, and a
#: digit (255) that only the last warp of each tile holds
RANK_CASES = ("one digit", "every digit 8 times", "digit only in the last warp")
#: K3 offset cases: every store on one offset, alternating offsets, the two
#: halves apart, stores skipped (out of range on either side, every one, all
#: but store 0, negative offsets down to -2^31)
STORE_CASES = ("lab", "all 0", "all 8", "0 then 8", "8 then 0", "halves", "outside",
               "all outside", "only store 0", "negative")


def case_keys(n: int, case: str, device: torch.device) -> torch.Tensor:
    """``(n,)`` int32 keys of :data:`RANK_CASES` ``case``, from the lab's
    seed-5 keys."""
    keys = make_keys(n, 5, device)
    pos = torch.arange(n, device=device) % K.TILE
    if case == "one digit":
        return (keys & -256) | 0x5A
    if case == "every digit 8 times":
        return (keys & -256) | (pos.flip(0) % K.DIGITS).to(torch.int32)
    if case == "digit only in the last warp":
        low = torch.where(pos < K.TILE * 3 // 4, (keys & 0xFF) % 255,
                          torch.where(pos % 3 == 0, 255, keys & 0xFF))
        return (keys & -256) | low.to(torch.int32)
    raise ValueError(f"unknown rank case {case!r}")


def case_offsets(tiles: int, case: str) -> np.ndarray:
    """K3's ``(tiles * 8, 128)`` int32 offset rows for :data:`STORE_CASES`
    ``case``; "lab" is :func:`make_offsets`."""
    offs = make_offsets(tiles)
    off = offs.reshape(tiles, K.OFF_ROWS * K.LANES)[:, :K.DIGITS]
    c = np.arange(K.DIGITS)
    if case in ("all 0", "all 8"):
        off[:] = int(case[-1])
    elif case in ("0 then 8", "8 then 0"):  # even stores (rows 0-7) at the first
        first, second = (0, 8) if case == "0 then 8" else (8, 0)
        off[:] = np.where(c % 2 == 0, first, second)
    elif case == "halves":  # c < 128 at 0, c >= 128 at 8
        off[:] = np.where(c < 128, 0, 8)
    elif case == "outside":  # stores at -1 and 9 are skipped
        off[:, 0::3] = -1
        off[:, 1::5] = 9
    elif case == "all outside":
        off[:] = np.where(c % 2 == 0, 9, -1)
    elif case == "only store 0":
        off[:, 1:] = K.MAX_OFFSET + 1
    elif case == "negative":
        off[:, 1::2] -= K.MAX_OFFSET + 1
        off[:, 0::7] = np.iinfo(np.int32).min
    elif case != "lab":
        raise ValueError(f"unknown store case {case!r}")
    return offs


# ---------------------------------------------------------------------------
# numpy oracles (keys as uint32)
# ---------------------------------------------------------------------------


def _groups(keys: np.ndarray) -> np.ndarray:
    tiles = len(keys) // K.TILE
    return ((keys & 0xFF).astype(np.int64).reshape(tiles, K.TILE)
            + np.arange(tiles, dtype=np.int64)[:, None] * K.DIGITS).reshape(-1)


def np_digit_histogram(keys: np.ndarray) -> np.ndarray:
    tiles = len(keys) // K.TILE
    return np.bincount(_groups(keys), minlength=tiles * K.DIGITS).reshape(tiles, K.DIGITS)


def np_rank(keys: np.ndarray) -> np.ndarray:
    """Stable rank of every key among its tile's keys of the same digit."""
    group = _groups(keys)
    order = np.argsort(group, kind="stable")
    ordered = group[order]
    rank = np.empty(len(keys), np.int64)
    rank[order] = np.arange(len(keys)) - np.searchsorted(ordered, ordered)
    return rank


def np_rank_sequential(tile: np.ndarray) -> np.ndarray:
    """One tile's ranks by counting key by key (``tools/pallas_sort_lab.py:238-245``)."""
    want = np.zeros(len(tile), np.int64)
    seen: dict = {}
    for i, d in enumerate((tile & 0xFF).tolist()):
        want[i] = seen.get(d, 0)
        seen[d] = seen.get(d, 0) + 1
    return want


def np_dynamic_store(keys: np.ndarray, offs: np.ndarray) -> np.ndarray:
    """The 256 stores of every tile, in order, over all tiles at once."""
    tiles = len(keys) // K.TILE
    src = keys.reshape(tiles, K.ROWS, K.LANES)
    off = offs.reshape(tiles, K.OFF_ROWS * K.LANES)[:, :K.DIGITS].astype(np.int64)
    out = np.zeros((tiles, K.ROWS, K.LANES), keys.dtype)
    every = np.arange(tiles)[:, None]
    for c in range(K.DIGITS):
        inside = (off[:, c] >= 0) & (off[:, c] <= K.MAX_OFFSET)
        g = c % (K.ROWS // 8)
        dest = off[inside, c][:, None] + np.arange(8)
        out[every[inside], dest] = src[inside, 8 * g:8 * g + 8]
    return out.reshape(tiles * K.ROWS, K.LANES)


def np_last_writers(offs: np.ndarray) -> np.ndarray:
    """K3's algorithm on the card, in numpy: ``(tiles, 16)``, the key row of
    its tile that each output row copies, or -1 where no store covers it.
    Output row ``r`` takes the last store ``c`` (in order) whose offset ``o``
    lies in ``[0, 8]`` with ``o <= r < o + 8``, and that store copies key
    row ``8 (c % 2) + r - o`` there."""
    tiles = len(offs) // K.OFF_ROWS
    off = offs.reshape(tiles, K.OFF_ROWS * K.LANES)[:, :K.DIGITS].astype(np.int64)
    inside = (off >= 0) & (off <= K.MAX_OFFSET)
    src = np.full((tiles, K.ROWS), -1, np.int64)
    for r in range(K.ROWS):
        covers = inside & (off <= r) & (r < off + 8)
        last = K.DIGITS - 1 - np.argmax(covers[:, ::-1], axis=1)
        start = np.take_along_axis(off, last[:, None], axis=1)[:, 0]
        src[:, r] = np.where(covers.any(axis=1), 8 * (last % 2) + r - start, -1)
    return src


def selected_rows(offs: np.ndarray) -> int:
    """Key rows, over all tiles, that some output row of K3 copies: the rows
    the function must read."""
    rows = np_last_writers(offs)
    seen = np.zeros((len(rows), K.ROWS + 1), bool)
    np.put_along_axis(seen, rows + 1, True, axis=1)
    return int(seen[:, 1:].sum())


def check(keys: torch.Tensor, offs: torch.Tensor, log=print) -> list[str]:
    """Each wrapper's output on ``keys`` against the numpy oracles over
    every key; returns the kernels that disagreed."""
    host = keys.cpu().numpy().view(np.uint32)
    n = len(host)
    hist = K.digit_histogram(keys).cpu().numpy()
    rank = K.rank_cumsum(keys).cpu().numpy().reshape(-1)
    stored = K.dynamic_store(keys, offs).cpu().numpy().view(np.uint32)
    results = {
        "digit_histogram": np.array_equal(hist, np_digit_histogram(host)),
        "rank_cumsum": (np.array_equal(rank, np_rank(host))
                        and np.array_equal(rank[:K.TILE], np_rank_sequential(host[:K.TILE]))),
        "dynamic_store": np.array_equal(stored, np_dynamic_store(host, offs.cpu().numpy())),
    }
    for name, ok in results.items():
        log(f"{name}: {'oracle-exact' if ok else 'FAILED the oracle check'} over {n} keys")
    return [name for name, ok in results.items() if not ok]


# ---------------------------------------------------------------------------
# the yardsticks and the timed rows
# ---------------------------------------------------------------------------


def sort1(keys: torch.Tensor) -> torch.Tensor:
    """The keys in unsigned order, as int32 bit patterns sign-flipped for
    the sort (one ``torch.sort``)."""
    return torch.sort(keys ^ SIGN32).values


def sort3(keys: torch.Tensor) -> torch.Tensor:
    """``x`` sorted by ``(x, (x * 40503) & 0xFFFFFF, iota)`` through the
    production route, the record sort; ``x`` as int64."""
    x = keys.to(torch.int64) & 0xFFFFFFFF
    umi = (x * UMI_MULT) & 0xFFFFFF
    iota = torch.arange(x.shape[0], dtype=torch.int64, device=x.device)
    rows = torch.stack([x, umi, iota], dim=1)
    return sort_cuda.sort_records(rows, sort_cuda.Hints((False, False, False)))[:, 0]


def bound_bytes(n: int, offs: np.ndarray | None = None) -> dict[str, int]:
    """Bytes each timed function must move for ``n`` keys: each input read
    once and each output written once. ``dynamic_store`` reads only the 256
    offsets of each tile, not the padding rows of its offset array, and of
    the keys only the rows that ``offs`` select (every row when ``offs`` is
    not given)."""
    tiles = n // K.TILE
    key_rows = tiles * K.ROWS if offs is None else selected_rows(offs)
    return {
        KERNEL_ROWS[0]: 4 * n + 4 * tiles * K.DIGITS,
        KERNEL_ROWS[1]: 8 * n,
        KERNEL_ROWS[2]: 4 * K.LANES * key_rows + 4 * n + 4 * tiles * K.DIGITS,
        SORT1: 8 * n,
        SORT3: 12 * n,
    }


def bound_ms(nbytes: int) -> float:
    return nbytes / (H.PEAK_GBPS * 1e6)


def time_rows(n: int, offs: torch.Tensor, device: torch.device,
              runs: int = H.DEFAULT_RUNS) -> list[dict]:
    """Time the three kernels and the two sorts, interleaved, over the timed
    key sets; one dict per row with ``ms``, ``ms_min``, ``bytes`` and
    ``bound_ms``."""
    sets = [{"keys": make_keys(n, seed, device)} for seed in TIMED_SEEDS]
    steps = {
        KERNEL_ROWS[0]: lambda s: K.digit_histogram(s["keys"]),
        KERNEL_ROWS[1]: lambda s: K.rank_cumsum(s["keys"]),
        KERNEL_ROWS[2]: lambda s: K.dynamic_store(s["keys"], offs),
        SORT1: lambda s: sort1(s["keys"]),
        SORT3: lambda s: sort3(s["keys"]),
    }
    times = H.time_interleaved(steps, sets, runs)
    nbytes = bound_bytes(n, offs.cpu().numpy())
    return [{"name": name, "n": n, "ms": times[name][0], "ms_min": times[name][1],
             "bytes": nbytes[name], "bound_ms": bound_ms(nbytes[name])} for name in steps]


def report(rows: list[dict]) -> list[str]:
    """The timing table and the verdict line."""
    lines = [f"{'row':<26} {'ms':>8} {'ms min':>8} {'Mkeys/s':>9} {'B/key':>6} "
             f"{'bound ms':>9} {'bound%':>7}"]
    for r in rows:
        lines.append(f"{r['name']:<26} {r['ms']:>8.4f} {r['ms_min']:>8.4f} "
                     f"{r['n'] / (r['ms'] * 1e3):>9.0f} {r['bytes'] / r['n']:>6.2f} "
                     f"{r['bound_ms']:>9.4f} {100.0 * r['bound_ms'] / r['ms']:>7.1f}")
    lines.append(verdict(rows))
    return lines


def verdict(rows: list[dict]) -> str:
    ms = {r["name"]: r["ms"] for r in rows}
    floor = max(ms[KERNEL_ROWS[1]], ms[KERNEL_ROWS[2]])
    return (f"per-pass floor (max of K2/K3): {floor:.4f} ms; 4-pass radix >= {4 * floor:.4f} ms "
            f"vs {SORT1} {ms[SORT1]:.4f} ms -> radix is {4 * floor / ms[SORT1]:.2f}x the "
            f"baseline ({4 * floor / ms[SORT3]:.2f}x the {SORT3}, {ms[SORT3]:.4f} ms); "
            "a lower bound: a radix pass also scans the global digit offsets and scatters "
            "every key, which this lab does not time")


def run(device: torch.device, n: int, runs: int = H.DEFAULT_RUNS, log=print
        ) -> tuple[list[dict], list[str]]:
    """Check the kernels on the seed-0 keys, then on a CUDA card time them
    beside the sorts. Returns the timed rows (none on the CPU) and the
    kernels that failed their check."""
    keys = make_keys(n, CHECK_SEED, device)
    offs = torch.from_numpy(make_offsets(K._check_keys(keys))).to(device)
    failed = check(keys, offs, log)
    if device.type != "cuda" or failed:
        return [], failed
    return time_rows(n, offs, device, runs), failed


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ibu_tpu_torch.labs.sort_lab",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--records", type=int, default=DEFAULT_KEYS,
                    help=f"keys, a multiple of {K.KEYS_MULTIPLE} (default 2^24)")
    ap.add_argument("--runs", type=int, default=H.DEFAULT_RUNS)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu: the plain versions, oracle checks, no timing")
    args = ap.parse_args(argv)
    device = select_device(args.device, ap.prog)
    if device is None:
        return 2
    print(f"sort_lab: {device} n={args.records} tile={K.TILE}", flush=True)
    try:
        rows, failed = run(device, args.records, args.runs, log=lambda line: print(line, flush=True))
    except ValueError as err:
        print(f"sort_lab: {err}", flush=True)
        return 2
    if device.type != "cuda":
        print("no timing: the plain versions ran on the CPU for the oracle checks", flush=True)
    elif not failed:
        for line in report(rows):
            print(line, flush=True)
    if failed:
        print(f"sort_lab: {len(failed)} kernel(s) failed: {', '.join(failed)}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
