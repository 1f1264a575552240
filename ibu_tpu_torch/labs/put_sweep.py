"""Host↔device copy rates by batch size: one put at a time and a sustained
train, through the production calls and through preallocated pinned buffers.

    python -m ibu_tpu_torch.labs.put_sweep [--sizes 0.25,0.5,1,2,4,8] [--reps 3]
        [--depth 4] [--budget-mb 256] [--device cpu]

The counterpart of ``tools/put_sweep.py``, with the reverse direction beside
it. For each size (millions of 24-byte records, as ``(B, 3)`` int64 wire
batches) it times, every put of distinct bytes (a seeded random batch XOR
a per-put salt):

- host → device: ``sync`` (one :func:`ibu_tpu_torch.ops.u64.to_device` at a
  time: the copy into a pinned buffer from the caching host allocator, then
  the asynchronous copy), ``sustained`` (``depth`` of them back to back, one
  synchronise at the end; ``depth`` is cut so the train holds at most
  ``--budget-mb``), and both again from preallocated pinned buffers already
  holding the bytes (``pinned_*``: the link alone);
- device → host: :func:`~ibu_tpu_torch.ops.u64.to_host` (a pinned buffer
  per call) one at a time (``d2h_sync``), and copies into preallocated pinned
  buffers, one at a time and ``depth`` back to back (``d2h_pinned_*``).

The first put and fetch of each size pay the pinned allocation
(``cudaHostAlloc``); they are reported apart (``cold_put_s``,
``cold_get_s``), and one more of each warms the size before the timed ones.
Every copy is checked exactly against its source bytes before the size's
line is printed. Timing: host clock around each call or train ending in
``torch.cuda.synchronize``. One JSON line per size.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ibu_tpu_torch.labs import _capacity as C
from ibu_tpu_torch.ops.u64 import to_device, to_host

SEED = 7
RECORD_BYTES = 24


class Source:
    """Distinct ``(b, 3)`` int64 host batches: one seeded random batch XOR
    a salt that changes with every batch."""

    def __init__(self, b: int, rng: np.random.Generator):
        self.base = np.frombuffer(rng.bytes(b * RECORD_BYTES), np.int64).reshape(b, 3)
        self.salt = 0

    def fill(self, out: np.ndarray) -> np.ndarray:
        self.salt += 1
        return np.bitwise_xor(self.base, np.int64(self.salt), out=out)

    def fresh(self) -> np.ndarray:
        return self.fill(np.empty_like(self.base))


def sweep_size(device, b: int, reps: int, depth: int, rng) -> dict:
    nbytes = b * RECORD_BYTES
    src = Source(b, rng)
    res = {"records": b, "MB": nbytes / 1e6, "depth": depth}

    def gbps(seconds, puts=1):
        return [puts * nbytes / s / 1e9 for s in seconds]

    host = src.fresh()
    dev, res["cold_put_s"] = C.clocked(lambda: to_device(host, device), device)
    back, res["cold_get_s"] = C.clocked(lambda: to_host(dev), device)
    C.require(C.holds(dev, host) and np.array_equal(back, host), f"the cold put and fetch of {b}")
    C.clocked(lambda: to_host(to_device(src.fresh(), device)), device)  # warm

    sync_t, kept = [], []
    for _ in range(reps):
        host = src.fresh()
        dev, dt = C.clocked(lambda: to_device(host, device), device)
        C.require(C.holds(dev, host), f"a {b}-record to_device")
        sync_t.append(dt)
        kept.append((dev, host))
    sus_t = []
    for _ in range(reps):
        hosts = [src.fresh() for _ in range(depth)]
        devs, dt = C.clocked(lambda: [to_device(h, device) for h in hosts], device)
        C.require(all(C.holds(d, h) for d, h in zip(devs, hosts)), f"a train of {b}-record puts")
        sus_t.append(dt)

    pinned = [torch.empty((b, 3), dtype=torch.int64, pin_memory=C.on_card(device))
              for _ in range(depth)]
    pin_t, pin_sus_t = [], []
    for _ in range(reps):
        host = src.fill(pinned[0].numpy())
        dev, dt = C.clocked(lambda: pinned[0].to(device, non_blocking=True), device)
        C.require(C.holds(dev, host), f"a {b}-record put from a pinned buffer")
        pin_t.append(dt)
    for _ in range(reps):
        hosts = [src.fill(p.numpy()) for p in pinned]
        devs, dt = C.clocked(lambda: [p.to(device, non_blocking=True) for p in pinned], device)
        C.require(all(C.holds(d, h) for d, h in zip(devs, hosts)),
                  f"a train of {b}-record puts from pinned buffers")
        pin_sus_t.append(dt)

    get_t, get_pin_t, get_pin_sus_t = [], [], []
    for dev, host in kept:
        back, dt = C.clocked(lambda: to_host(dev), device)
        C.require(np.array_equal(back, host), f"a {b}-record to_host")
        get_t.append(dt)
    for dev, host in kept:
        _, dt = C.clocked(lambda: pinned[0].copy_(dev, non_blocking=True), device)
        C.require(np.array_equal(pinned[0].numpy(), host),
                  f"a {b}-record fetch into a pinned buffer")
        get_pin_t.append(dt)
    train = [d for d, _ in kept] * depth
    for _ in range(reps):
        _, dt = C.clocked(lambda: [p.copy_(d, non_blocking=True) for p, d in zip(pinned, train)],
                        device)
        C.require(all(np.array_equal(p.numpy(), h) for p, (_, h) in zip(pinned, kept * depth)),
                  f"a train of {b}-record fetches into pinned buffers")
        get_pin_sus_t.append(dt)

    res.update({
        "sync_GB_s": gbps(sync_t),
        "sustained_GB_s": gbps(sus_t, depth),
        "pinned_sync_GB_s": gbps(pin_t),
        "pinned_sustained_GB_s": gbps(pin_sus_t, depth),
        "d2h_sync_GB_s": gbps(get_t),
        "d2h_pinned_sync_GB_s": gbps(get_pin_t),
        "d2h_pinned_sustained_GB_s": gbps(get_pin_sus_t, depth),
    })
    return res


def run(device, sizes: list[float], reps: int, depth: int, budget_mb: float) -> list[dict]:
    C.log(f"put_sweep: {C.device_name(device)}")
    rng = np.random.default_rng(SEED)
    out = []
    for spec in sizes:
        b = int(spec * (1 << 20))
        d = max(1, min(depth, int(budget_mb * 1e6 / (b * RECORD_BYTES))))
        res = sweep_size(device, b, reps, d, rng)
        C.log(f"  {spec}M records ({res['MB']:.1f} MB): checked")
        C.log_time(device, "    H2D sync {sync_GB_s} sustained(d={depth}) {sustained_GB_s} "
                   "pinned {pinned_sync_GB_s} / {pinned_sustained_GB_s}; D2H {d2h_sync_GB_s} "
                   "pinned {d2h_pinned_sync_GB_s} / {d2h_pinned_sustained_GB_s} GB/s".format(
                       **{k: [round(x, 2) for x in v] if isinstance(v, list) else v
                          for k, v in res.items()}))
        out.append(res if C.on_card(device) else {k: res[k] for k in ("records", "MB", "depth")})
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ibu_tpu_torch.labs.put_sweep",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--sizes", default="0.25,0.5,1,2,4,8",
                    help="batch sizes in millions of records (2^20, 24 bytes each)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--budget-mb", type=float, default=256.0,
                    help="the most bytes one sustained train moves")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu: the checks, no timing")
    args = ap.parse_args(argv)
    device = C.lab_device(args.device, ap.prog)
    if device is None:
        return 2
    sizes = [float(s) for s in args.sizes.split(",")]
    for line in run(device, sizes, args.reps, args.depth, args.budget_mb):
        C.emit(line, device, C.HOST_CLOCK)
    return 0


if __name__ == "__main__":
    sys.exit(main())
