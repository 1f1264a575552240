"""What the device-capacity and feed labs share: the card, resident batches,
chain timing, the byte bound and the printed lines.

Each lab (``engine_capacity_lab``, ``histogram_capacity_lab``,
``molcount_capacity_lab``, ``sort_keys_lab``, ``stream_lab``, ``put_sweep``,
``put_source_lab``) runs as ``python -m ibu_tpu_torch.labs.<name>``, on the
card unless given ``--device cpu``; without a card and without that flag it
prints :func:`~ibu_tpu_torch.utils.device.resolve_device`'s
:class:`~ibu_tpu_torch.errors.NoCardError` text on stderr and exits 2.
Progress goes to stderr and each result to stdout as one JSON line, with the
device's name (``device``) and how it was timed (``timer``). Every lab runs
its exact oracle checks before it times anything, and a failed check raises
with no result line.

On the card, a resident-batch lab times chains of ``k`` steps over ``D``
distinct batches placed beforehand, with CUDA events around each chain, after
one untimed chain; the per-step figure is the chain's time over ``k``, best
and median over the repetitions, with the host's time to issue a step beside
it (``issue_ms``: equal to the step's time where launches, not the card, set
the rate). The bound is the bytes a step must read
once (and write once, where it writes), over the H100's
:data:`~ibu_tpu_torch.labs._harness.PEAK_GBPS`. On the CPU the labs run the
same checks and print the same keys with every time, rate and bound null: a
CPU run measures no device.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
from typing import Callable

import numpy as np
import torch

from ibu_tpu_torch.errors import NoCardError
from ibu_tpu_torch.labs._harness import PEAK_GBPS
from ibu_tpu_torch.ops.u64 import to_device
from ibu_tpu_torch.utils.device import resolve_device

EVENTS = "CUDA events around chains of k steps over distinct resident batches"
HOST_CLOCK = "host clock around each call ending in torch.cuda.synchronize"
SHM = "/dev/shm"


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def log_time(device: torch.device, *parts) -> None:
    """A progress line that carries a time or rate: printed on the card only."""
    if on_card(device):
        log(*parts)


def lab_device(arg: str | None, prog: str) -> torch.device | None:
    """``--device``: the card, or the CPU only when asked for by name.
    ``None`` (after ``resolve_device``'s text on stderr) without a card."""
    try:
        return resolve_device(arg)
    except NoCardError as err:
        log(f"{prog}: {err}")
        return None


def on_card(device: torch.device) -> bool:
    return device.type == "cuda"


def sync(device: torch.device) -> None:
    if on_card(device):
        torch.cuda.synchronize(device)


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if on_card(device) else "cpu"


def wire(raw: np.ndarray) -> np.ndarray:
    """A ``(B, 6)`` uint32 (or any 24-byte-row) host batch as the ``(B, 3)``
    int64 wire view of the same bytes."""
    return np.ascontiguousarray(raw).view(np.int64).reshape(-1, 3)


def place(hosts: list[np.ndarray], device: torch.device) -> list[torch.Tensor]:
    """Each host batch as a ``(B, 3)`` int64 tensor on ``device``, all
    copies finished."""
    placed = [to_device(wire(h), device) for h in hosts]
    sync(device)
    return placed


def scratch_dir(prefix: str, nbytes: int, workdir: str | None = None) -> str:
    """A new directory for a lab's files of ``nbytes`` in all: under
    ``workdir`` when given, else in ``/dev/shm`` where it has room for them
    (a container's may hold only 64 MB), else in the temporary directory."""
    if workdir is None and os.path.isdir(SHM) and shutil.disk_usage(SHM).free > 2 * nbytes:
        workdir = SHM
    if workdir is not None:
        os.makedirs(workdir, exist_ok=True)
    return tempfile.mkdtemp(prefix=prefix, dir=workdir)


def clocked(fn: Callable[[], object], device: torch.device) -> tuple[object, float]:
    """``(fn(), seconds)``: the host clock around ``fn()`` and a synchronise."""
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def holds(dev: torch.Tensor, host: np.ndarray) -> bool:
    """``dev`` holds exactly ``host``'s bytes (compared on ``dev``'s device)."""
    return torch.equal(dev, to_device(host, dev.device))


@contextlib.contextmanager
def no_host_waits(device: torch.device):
    """CUDA's sync debug mode at ``"error"``: any step inside that waits on
    the card raises instead of hiding in the time."""
    if not on_card(device):
        yield
        return
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def time_chain(prepare: Callable[[int], Callable[[], object]], k: int, reps: int,
               guard: Callable[[], contextlib.AbstractContextManager] = contextlib.nullcontext
               ) -> tuple[list[float], list[float]]:
    """Milliseconds per step of ``reps`` chains of ``k`` steps, after one
    untimed chain: ``go = prepare(k)`` sets a chain up (untimed), and CUDA
    events are recorded around ``go()``, which runs inside ``guard()``.
    Returns the card's times and the host's (the host clock around issuing
    the chain): where the two are equal, issuing the steps, not the card,
    sets the rate."""
    card, host = [], []
    for rep in range(reps + 1):
        go = prepare(k)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with guard():
            t0 = time.perf_counter()
            start.record()
            go()
            end.record()
            issued = time.perf_counter() - t0
        end.synchronize()
        if rep:
            card.append(start.elapsed_time(end) / k)
            host.append(issued * 1e3 / k)
    return card, host


def chain_times(prepare, ks, reps: int, device: torch.device, guard=contextlib.nullcontext
                ) -> dict | None:
    """:func:`time_chain` at each ``k``: ``{"k": [...], "best_s": {k: ..},
    "best_ms": {k: ..}, "median_ms": {k: ..}, "issue_ms": {k: ..}}``
    (``best_s``: the best chain's seconds, the JAX labs' key; the others per
    step, ``issue_ms`` the host's best time to issue one), ``None`` on the CPU
    (nothing timed)."""
    if not on_card(device):
        return None
    runs = {k: time_chain(prepare, k, reps, guard) for k in ks}
    return {
        "k": list(ks),
        "best_s": {k: min(card) * k / 1e3 for k, (card, _) in runs.items()},
        "best_ms": {k: min(card) for k, (card, _) in runs.items()},
        "median_ms": {k: statistics.median(card) for k, (card, _) in runs.items()},
        "issue_ms": {k: min(host) for k, (_, host) in runs.items()},
    }


def bound_ms(nbytes: int) -> float:
    """The least time the H100 takes to move ``nbytes`` at its peak rate."""
    return nbytes / (PEAK_GBPS * 1e6)


def rates(times: dict | None, records: int, step_bytes: int, bound_bytes: int,
          device: torch.device) -> dict:
    """The headline figures of a timed chain: the best per-step ms of the
    longest chain and the host's time to issue a step, GB/s of ``step_bytes``
    per step, Mrec/s, and the bound of ``bound_bytes`` beside it; null on the
    CPU."""
    if times is None:
        return {"per_batch_ms": None, "issue_ms": None, "GB_s": None, "Mrec_s": None,
                "bound_ms": None, "pct_of_bound": None}
    k = max(times["k"])
    ms = times["best_ms"][k]
    bound = bound_ms(bound_bytes)
    return {
        "per_batch_ms": ms,
        "issue_ms": times["issue_ms"][k],
        "GB_s": step_bytes / (ms * 1e6),
        "Mrec_s": records / (ms * 1e3),
        "bound_ms": bound,
        "pct_of_bound": 100.0 * bound / ms,
    }


def emit(result: dict, device: torch.device, timer: str | None) -> dict:
    """Print ``result`` as one JSON line on stdout, with ``device`` and
    ``timer`` (null on the CPU); returns the printed dict."""
    line = {**result, "device": device_name(device), "timer": timer if on_card(device) else None}
    print(json.dumps(line), flush=True)
    return line


def require(cond: bool, what: str) -> None:
    """An oracle check: raises (so no result line is printed) unless ``cond``."""
    if not cond:
        raise RuntimeError(f"oracle check failed: {what}")
