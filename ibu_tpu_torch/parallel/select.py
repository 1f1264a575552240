"""Transport-aware engine auto-selection.

Counterpart of :mod:`ibu_tpu.parallel.select`. A device engine is bounded end
to end by the host→device copies it pays per batch; the host engines never
cross the link. ``engine="auto"`` probes both sides once per process and
routes each streaming call to the faster engine on this machine, saying so
on stderr.

Order of decisions in every ``auto_*`` function, so that nothing hides the
card:

1. ``IBU_AUTO_ENGINE`` set: it decides, with no probe and no device lookup.
2. Otherwise the device is resolved first
   (:func:`ibu_tpu_torch.utils.device.resolve_device`): ``device=None``
   without a CUDA card raises ``RuntimeError`` before any probe. ``"auto"``
   never turns "no card" into "host" silently.
3. The resolved device is the CPU (asked for by name): no probe, since a
   copy to the same memory says nothing about a link. The codec takes the
   native host codec when it is built, else the plain torch codec
   (``"device"``); the histogram takes ``"host"``. The JAX package answers
   the same on its CPU backend.
4. A CUDA device: probe, decide, announce.

Probes:

* :func:`measure_device_feed_gbps`: sustained host→device bandwidth of
  record-sized blocks through the route the engines use
  (:func:`ibu_tpu_torch.ops.u64.to_device`: a numpy copy into a pinned
  buffer, then an asynchronous copy), ended by a synchronise, so it measures
  what a batch pays and not the bare link;
* :func:`measure_native_recs_per_s`: the native threaded checksum engine
  timed on a prefix of the actual input file.

Both are memoized per process and the decision is pure
(:func:`choose_stats_engine` takes injected probe values), so the logic
tests with fake clocks and no hardware.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from ibu_tpu_torch import native
from ibu_tpu_torch.ops.u64 import to_device
from ibu_tpu_torch.utils.device import resolve_device

#: per-process probe memo: {"device_gbps": float, "native_recs": float|None, ...}
_MEMO: dict = {}

#: feed probe block: big enough to amortize the launch of a copy, small
#: enough that a very slow link still answers in a fraction of a second
PROBE_BYTES = 8 << 20

#: native probe prefix: 4M records (96 MB), cheap next to any full pass
PROBE_RECORDS = 4 << 20


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_device_feed_gbps(
    device: str | torch.device | None = None,
    probe_bytes: int = PROBE_BYTES,
    timer=time.perf_counter,
    min_seconds: float = 0.05,
    max_puts: int = 8,
) -> float:
    """Sustained host→device bandwidth (GB/s) of the streaming wire layout:
    timed :func:`ibu_tpu_torch.ops.u64.to_device` of ``(B, 3)`` int64 blocks
    (pageable numpy → pinned staging buffer → asynchronous copy), each ended
    by a synchronise, after one small warm-up copy (allocator set-up).

    Each put gets a distinct leading word, as in the JAX package's probe.
    Puts repeat until ``min_seconds`` of measured time or ``max_puts``,
    whichever comes first.
    """
    device = resolve_device(device)
    rows = max(1, probe_bytes // 24)
    blk = np.zeros((rows, 3), dtype=np.int64)
    blk[:, 2] = np.arange(rows, dtype=np.int64)  # non-trivial payload

    to_device(np.zeros((1, 3), dtype=np.int64), device)
    _sync(device)

    elapsed = 0.0
    done = 0
    for i in range(max_puts):
        blk[0, 0] = i + 1  # distinct per put
        t0 = timer()
        to_device(blk, device)
        _sync(device)
        elapsed += timer() - t0
        done += 1
        if elapsed >= min_seconds:
            break
    return done * blk.nbytes / max(elapsed, 1e-9) / 1e9


def measure_native_recs_per_s(
    path: str,
    n_records: int,
    probe_records: int = PROBE_RECORDS,
    timer=time.perf_counter,
) -> float | None:
    """Native threaded host engine rate (records/s), timed on a prefix of
    the actual file. ``None`` when the native runtime is unavailable or the
    file is empty (nothing to probe, and nothing to route)."""
    if n_records <= 0 or not native.available():
        return None
    k = min(n_records, probe_records)
    native.checksum_parallel(path, min(k, 1024))  # warm: mmap + thread pool
    t0 = timer()
    native.checksum_parallel(path, k)
    dt = timer() - t0
    return k / max(dt, 1e-9)


def host_numpy_recs_per_s() -> float:
    """A-priori floor for the single-threaded numpy host engine, used only
    when the native runtime is unavailable, as the bar the device feed must
    beat. A conservative constant, not a measurement: low enough that a
    healthy device link always wins against it."""
    return 40e6


def probe_rates(path: str, n_records: int, device: str | torch.device | None = None) -> dict:
    """Measure (once per process) and memoize the two probe rates."""
    if "device_gbps" not in _MEMO:
        _MEMO["device_gbps"] = measure_device_feed_gbps(device=device)
    # the native rate is dominated by the engine, not the file: memoize on
    # first use like the feed probe
    if "native_recs" not in _MEMO:
        rate = measure_native_recs_per_s(path, n_records)
        if rate is not None:
            _MEMO["native_recs"] = rate
        else:
            if not native.available():
                # permanently unavailable: cache the verdict
                _MEMO["native_recs"] = None
            # else this FILE was empty (nothing to probe); the memo stays
            # open and the next call on a real file probes again
            return {**_MEMO, "native_recs": None}
    return dict(_MEMO)


def reset_probe_memo() -> None:
    """Forget memoized probes (tests; or after the transport changed)."""
    _MEMO.clear()


def choose_stats_engine(
    device_gbps: float,
    native_recs: float | None,
    margin: float = 1.0,
) -> tuple[str, str]:
    """Pure decision: fastest engine for a streaming whole-file pass.

    ``device_gbps`` is the measured feed bandwidth; the device end-to-end
    record rate is taken as ``feed / 24 B``. ``native_recs`` is the measured
    native engine rate or ``None`` when unavailable (the numpy host floor
    stands in). ``margin`` > 1 biases toward the host side (hysteresis).
    Returns ``(engine, reason)`` with ``engine`` ∈ {"device", "native",
    "host"}.
    """
    device_recs = device_gbps * 1e9 / 24.0
    host_engine = "native" if native_recs is not None else "host"
    host_recs = native_recs if native_recs is not None else host_numpy_recs_per_s()
    if device_recs >= host_recs * margin:
        return "device", (
            f"device feed {device_gbps:.2f} GB/s "
            f"(~{device_recs / 1e6:.0f} Mrec/s) >= {host_engine} "
            f"~{host_recs / 1e6:.0f} Mrec/s"
        )
    return host_engine, (
        f"device feed {device_gbps:.2f} GB/s "
        f"(~{device_recs / 1e6:.0f} Mrec/s) is below the {host_engine} "
        f"host engine (~{host_recs / 1e6:.0f} Mrec/s) — staying on host"
    )


def auto_stats_engine(
    path: str,
    n_records: int,
    device: str | torch.device | None = None,
    announce: bool = True,
) -> str:
    """Probe (memoized) + decide + optionally announce on stderr. The stats
    engines have no CPU carve-out, as in the JAX package: with
    ``device="cpu"`` the feed probe times the copy into a CPU tensor."""
    env = os.environ.get("IBU_AUTO_ENGINE")
    if env:  # operator override: skip probing entirely
        return env
    rates = probe_rates(path, n_records, device=resolve_device(device))
    engine, reason = choose_stats_engine(rates["device_gbps"], rates["native_recs"])
    if announce:
        print(f"engine auto: {reason} -> {engine} "
              "(--engine forces a specific one)", file=sys.stderr)
    return engine


def measure_native_codec_recs(
    length: int = 28, probe_rows: int = 1 << 18, timer=time.perf_counter
) -> float | None:
    """Threaded native host codec rate (records/s): time ``pack_2bit`` on a
    synthetic ``(N, L)`` block. ``None`` when native is unavailable (the
    numpy codec floor stands in)."""
    if not native.available():
        return None
    rows = np.frombuffer(b"ACGT", dtype=np.uint8)[
        (np.arange(probe_rows)[:, None] + np.arange(length)[None, :]) % 4
    ]
    native.pack_2bit(rows[:1024], validate=False)  # warm threads/pages
    t0 = timer()
    native.pack_2bit(rows, validate=False)
    return probe_rows / max(timer() - t0, 1e-9)


def numpy_codec_recs_per_s() -> float:
    """A-priori floor for the numpy codec: a conservative constant, not a
    measurement."""
    return 5e6


#: encode moves about (L + 8) ASCII and index bytes up and 24 record bytes
#: down per record; decode the reverse. 64 B/record is a round conservative
#: figure for the feed-rate → codec-records conversion.
CODEC_BYTES_PER_RECORD = 64.0


def auto_codec_engine(device: str | torch.device | None = None, announce: bool = True) -> str:
    """Device-vs-host decision for the record codec paths (encode and decode
    batches: FASTQ ingest and export, TSV decode).

    The host bar is the THREADED native host codec
    (:func:`measure_native_codec_recs`) and the device side pays about
    :data:`CODEC_BYTES_PER_RECORD` of link traffic per record. Memoized;
    announced once; ``IBU_AUTO_ENGINE`` overrides (``device`` → device,
    anything else → host).
    """
    env = os.environ.get("IBU_AUTO_ENGINE")
    if env:
        return "device" if env == "device" else "host"
    device = resolve_device(device)  # no card and no device named: raises
    # one verdict per kind of device: a process may use the CPU by name and
    # the card side by side
    key = "codec_engine" if device.type == "cuda" else "codec_engine_cpu"
    if key in _MEMO:
        return _MEMO[key]
    if device.type == "cpu":
        # the "device" path is the plain torch codec on the host, and the
        # feed probe would time a copy to the same memory. The native codec
        # is the faster of the two when built.
        engine = "host" if native.available() else "device"
        _MEMO[key] = engine
        if announce:
            print(
                f"codec engine auto: cpu backend -> {engine} "
                "(IBU_AUTO_ENGINE overrides)",
                file=sys.stderr,
            )
        return engine
    if "device_gbps" not in _MEMO:
        _MEMO["device_gbps"] = measure_device_feed_gbps(device=device)
    if "native_codec_recs" not in _MEMO:
        _MEMO["native_codec_recs"] = measure_native_codec_recs()
    device_recs = _MEMO["device_gbps"] * 1e9 / CODEC_BYTES_PER_RECORD
    host_recs = _MEMO["native_codec_recs"]
    host_name = "native codec"
    if host_recs is None:
        host_recs = numpy_codec_recs_per_s()
        host_name = "numpy codec"
    engine = "device" if device_recs >= host_recs else "host"
    _MEMO[key] = engine
    if announce:
        print(
            f"codec engine auto: device link ~{device_recs/1e6:.0f} Mrec/s "
            f"vs {host_name} ~{host_recs/1e6:.0f} Mrec/s -> {engine} "
            "(IBU_AUTO_ENGINE overrides)",
            file=sys.stderr,
        )
    return engine


def measure_host_histogram_recs(
    probe_records: int = 1 << 20, timer=time.perf_counter
) -> float:
    """The host histogram engine's actual rate: ``np.unique`` group-sum over
    synthetic u64 barcodes, the work
    :func:`ibu_tpu_torch.pipelines.host_stream_histogram` really does (not the
    native checksum, which a histogram cannot use)."""
    vals = (
        np.arange(probe_records, dtype=np.uint64) * np.uint64(2654435761)
    ) % np.uint64(4096)
    np.unique(vals[:4096], return_counts=True)  # warm
    t0 = timer()
    np.unique(vals, return_counts=True)
    return probe_records / max(timer() - t0, 1e-9)


def auto_device_or_host(
    device: str | torch.device | None = None,
    what: str = "histogram",
    announce: bool = True,
) -> str:
    """Binary device-vs-host decision for streaming tools whose host side is
    the numpy pass (histogram): the device feed probe against the MEASURED
    host-histogram rate, collapsed to ``{"device", "host"}``. On the CPU the
    "device" is the same host, so the answer is ``"host"`` without a probe,
    matching :func:`auto_codec_engine`'s rule."""
    env = os.environ.get("IBU_AUTO_ENGINE")
    if env:
        return "device" if env == "device" else "host"
    device = resolve_device(device)  # no card and no device named: raises
    if device.type == "cpu":
        if announce:
            print(f"engine auto ({what}): cpu backend -> host "
                  "(--engine forces a specific one)", file=sys.stderr)
        return "host"
    if "device_gbps" not in _MEMO:
        _MEMO["device_gbps"] = measure_device_feed_gbps(device=device)
    if "host_hist_recs" not in _MEMO:
        _MEMO["host_hist_recs"] = measure_host_histogram_recs()
    device_recs = _MEMO["device_gbps"] * 1e9 / 24.0
    host_recs = _MEMO["host_hist_recs"]
    engine = "device" if device_recs >= host_recs else "host"
    if announce:
        print(
            f"engine auto ({what}): device feed "
            f"~{device_recs / 1e6:.0f} Mrec/s vs host numpy "
            f"~{host_recs / 1e6:.0f} Mrec/s -> {engine} "
            "(--engine forces a specific one)",
            file=sys.stderr,
        )
    return engine
