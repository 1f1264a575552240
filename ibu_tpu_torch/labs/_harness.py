"""Inputs, host oracle, timing and byte accounting shared by the codec labs.

Inputs follow the TPU labs' formula (``tools/sol_lab.py::make_inputs`` /
``host_rows``, ``tools/kernel_lab.py::make_inputs``) turned row-major: base
``p`` of record ``r`` in input set ``k`` has code ``(p * 7 + r + k) % 4``, the
barcode holding bases 0-15 and the UMI bases 16-27 of that sequence, and the
index is ``arange(N)``. The sets ``k = 0, 1, 2`` are distinct, so a timed run
that cycles them never reads a buffer the last call left in cache. Sets are
made on the device.

Every row repeats with period 4 in ``r``, so the host oracle (the port's
numpy codec, :mod:`ibu_tpu_torch.ops.codec`, and numpy statements of what the
floor modes write) evaluates the first four records and the comparison runs
over all N on the device, exactly.

Timing uses CUDA events around each run of calls, cycling the sets; the runs
of all variants are interleaved after a warm-up round, and it reports the
mean and the min of the per-call time over the runs. Bytes are counted as
the TPU labs count them (``USEFUL_BYTES``, 120 per bc16/umi12 round trip)
whatever a layout moves; what it really moves is reported beside.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ibu_tpu_torch.labs._kernels import BC, CODEC_DEC, CODEC_ENC, COMB, UMI
from ibu_tpu_torch.ops.codec import np_pack, np_unpack

#: bytes per bc16/umi12 round trip: 36 in and 24 out to encode, the reverse
#: to decode (``tools/kernel_lab.py::USEFUL_BYTES``)
USEFUL_BYTES = 2 * (BC + UMI + 8 + 24)
#: NVIDIA's published device-memory bandwidth of the H100 SXM, GB/s
PEAK_GBPS = 3350.0
N_SETS = 3
PERIOD = 4
DEFAULT_RECORDS = 1 << 24
DEFAULT_RUNS = 10


def host_rows(n: int, length: int, base0: int = 0, k: int = 0) -> np.ndarray:
    """``(n, length)`` ASCII rows of the lab formula (host)."""
    p = np.arange(length)[None, :] + base0
    r = np.arange(n)[:, None] + k
    code = (p * 7 + r) % 4
    return (65 + 2 * code + 2 * (code >> 1) + 11 * (code & (code >> 1))).astype(np.uint8)


def make_inputs(n: int, k: int, device: torch.device) -> dict[str, torch.Tensor]:
    """Input set ``k`` of ``n`` records on ``device``: ``bc`` (N, 16) and
    ``umi`` (N, 12) uint8, ``comb`` (N, 32) uint8 with bases 28-31 'A',
    ``bcp`` (N, 4) and ``umip`` (N, 3) int32 words over the same bytes as
    ``bc`` and ``umi``, and ``index`` (N,) int64."""
    seq = torch.from_numpy(host_rows(PERIOD, BC + UMI, 0, k)).to(device)
    phase = torch.arange(n, device=device) % PERIOD
    bc = seq[:, :BC][phase]
    umi = seq[:, BC:][phase]
    comb = torch.cat([seq, torch.full((PERIOD, COMB - BC - UMI), 65, dtype=torch.uint8,
                                      device=device)], dim=1)[phase]
    return {
        "bc": bc,
        "umi": umi,
        "comb": comb,
        "bcp": bc.view(torch.int32),
        "umip": umi.view(torch.int32),
        "index": torch.arange(n, dtype=torch.int64, device=device),
    }


def make_sets(n: int, device: torch.device) -> list[dict[str, torch.Tensor]]:
    return [make_inputs(n, k, device) for k in range(N_SETS)]


# ---------------------------------------------------------------------------
# host oracle
# ---------------------------------------------------------------------------


def _le_words(rows: np.ndarray) -> np.ndarray:
    """``(n, 8k)`` uint8 → ``(n, k)`` uint64 little-endian words."""
    return np.ascontiguousarray(rows).view("<u8")


def np_encode(mode: str, bc: np.ndarray, umi: np.ndarray) -> np.ndarray:
    """What encode ``mode`` writes to the barcode and UMI words: ``(n, 2)``
    uint64. The codec modes pack (:func:`np_pack`); ``touch`` folds each row
    with one XOR per 8 bytes; ``reduce`` takes each row's largest byte."""
    if mode in CODEC_ENC:
        return np.stack([np_pack(bc), np_pack(umi)], axis=1)
    if mode == "touch":
        b = _le_words(bc)
        u = _le_words(np.concatenate([umi, np.zeros((len(umi), 4), np.uint8)], axis=1))
        return np.stack([b[:, 0] ^ b[:, 1], u[:, 0] ^ u[:, 1]], axis=1)
    if mode == "reduce":
        return np.stack([bc.max(axis=1), umi.max(axis=1)], axis=1).astype(np.uint64)
    raise ValueError(f"unknown encode mode {mode!r}")


def np_decode(mode: str, words: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """What decode ``mode`` writes from ``(n, 2)`` uint64 barcode and UMI
    words: ``(n, 16)`` and ``(n, 12)`` uint8 rows. The codec modes unpack
    (:func:`np_unpack`); ``touch`` writes the words' 16 bytes as the barcode
    and their first 12 as the UMI; ``reduce`` writes the largest of those 16
    bytes into every base."""
    words = np.ascontiguousarray(words, dtype=np.uint64)
    if mode in CODEC_DEC:
        return np_unpack(words[:, 0], BC), np_unpack(words[:, 1], UMI)
    raw = words.view(np.uint8).reshape(len(words), 16)
    if mode == "touch":
        return raw.copy(), raw[:, :UMI].copy()
    if mode == "reduce":
        top = raw.max(axis=1, keepdims=True)
        return np.repeat(top, BC, axis=1), np.repeat(top, UMI, axis=1)
    raise ValueError(f"unknown decode mode {mode!r}")


def period_inputs(k: int) -> tuple[np.ndarray, np.ndarray]:
    """The four distinct barcode and UMI rows of input set ``k``."""
    return host_rows(PERIOD, BC, 0, k), host_rows(PERIOD, UMI, BC, k)


def tiled(want: np.ndarray, n: int, device: torch.device) -> torch.Tensor:
    """The period-4 oracle ``want`` (4 leading rows) repeated over ``n``
    records, on ``device``."""
    table = torch.from_numpy(np.ascontiguousarray(want)).to(device)
    return table[torch.arange(n, device=device) % PERIOD]


def same(got: torch.Tensor, want: np.ndarray, n: int) -> bool:
    """``got`` equals the period-4 oracle ``want`` over all ``n`` records."""
    if want.dtype == np.uint64:
        want = want.view(np.int64)
    expect = tiled(want, n, got.device)
    return got.shape == expect.shape and got.dtype == expect.dtype and torch.equal(got, expect)


def is_arange(index: torch.Tensor) -> bool:
    return torch.equal(index, torch.arange(index.shape[0], dtype=torch.int64, device=index.device))


# ---------------------------------------------------------------------------
# timing and the table
# ---------------------------------------------------------------------------


def time_interleaved(steps: dict, sets: list, runs: int = DEFAULT_RUNS) -> dict:
    """Mean and min ms per call of each ``steps[name](inputs)``: CUDA events
    around each run of ``2 * len(sets)`` calls cycling ``sets``. The runs
    are interleaved (round ``i`` times every step once, in turn), so a drift
    of the card's clocks during the measurement falls on every step alike;
    one untimed round warms them up first."""
    calls = 2 * len(sets)

    def one_run(step) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(calls):
            step(sets[i % len(sets)])
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls

    for step in steps.values():
        one_run(step)
    times = {name: [] for name in steps}
    for _ in range(runs):
        for name, step in steps.items():
            times[name].append(one_run(step))
    return {name: (sum(t) / len(t), min(t)) for name, t in times.items()}


@dataclass
class Row:
    """One timed variant: ms per round trip over ``n`` records, moving
    ``moved`` bytes per record."""

    name: str
    n: int
    ms: float
    ms_min: float
    moved: int
    note: str = ""
    useful: int = USEFUL_BYTES

    def gbps(self) -> float:
        """Useful GB/s at ``useful`` bytes per record."""
        return self.n * self.useful / (self.ms * 1e6)

    def moved_gbps(self) -> float:
        return self.n * self.moved / (self.ms * 1e6)

    def as_dict(self, floor_ms: float) -> dict:
        return {
            "name": self.name, "n": self.n, "ms": self.ms, "ms_min": self.ms_min,
            "gbps": self.gbps(), "moved_bytes": self.moved, "moved_gbps": self.moved_gbps(),
            "sol_pct": 100.0 * floor_ms / self.ms, "peak_pct": 100.0 * self.gbps() / PEAK_GBPS,
        }


def table(rows: list[Row], floor_ms: float) -> list[str]:
    """The printed table: ``sol_pct`` is the copy floor's time over the
    variant's (100 at the floor), ``peak%`` useful GB/s over
    :data:`PEAK_GBPS`."""
    lines = [f"{'variant':<18} {'ms':>8} {'ms min':>8} {'GB/s':>8} {'sol_pct':>8} "
             f"{'peak%':>6} {'B moved':>8} {'moved GB/s':>10}  note"]
    for row in rows:
        d = row.as_dict(floor_ms)
        lines.append(
            f"{row.name:<18} {row.ms:>8.4f} {row.ms_min:>8.4f} {d['gbps']:>8.1f} "
            f"{d['sol_pct']:>8.1f} {d['peak_pct']:>6.1f} {row.moved:>8d} "
            f"{d['moved_gbps']:>10.1f}  {row.note}".rstrip()
        )
    return lines


def floor_line(floor: Row) -> str:
    return (f"copy floor (sol_touch): {floor.ms:.4f} ms per round trip of {floor.n} records "
            f"(min {floor.ms_min:.4f}), {floor.gbps():.1f} GB/s at {USEFUL_BYTES} B/record, "
            f"{100.0 * floor.gbps() / PEAK_GBPS:.1f}% of {PEAK_GBPS:.0f} GB/s")
