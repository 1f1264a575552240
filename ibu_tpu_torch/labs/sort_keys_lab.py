"""The record sort by its keys: hinted, unhinted and one-key, on the card.

    python -m ibu_tpu_torch.labs.sort_keys_lab [--records 1048576 16777216]
        [--sets 4] [--reps 3] [--device cpu]

The port's counterpart of ``tools/sort_lab.py``, which times ``lax.sort`` at
6, 4, 3 and 1 operands. Here the record sort is
:func:`ibu_tpu_torch.ops.stats.sort_records` (stable argsort passes over
sign-flipped int64 keys, neighbouring narrow keys packed into one):

- ``unhinted``: three 64-bit keys, three passes;
- ``hinted``: ``bc_len=16, umi_len=16, index_bits=32, check=False``, the
  barcode and UMI packed into one key, two passes;
- ``torch.sort 1-key``: ``torch.sort`` of the barcode column alone, the
  floor of any comparison sort of these records.

Inputs are made on the card with the reference's formula and seeds: record
``i`` of seed ``s`` has barcode ``x = ((i * 2654435761) ^ (i >> 3) ^ s) mod
2^32``, UMI ``(x * 40503) & 0xFFFFFF`` and index ``i``, for ``--sets``
seeds 1000, 1001, ... (so the hints hold). Every output on every set is
checked before anything is timed: the record sorts against the host copy
reordered by ``np.lexsort``, the one-key sort against ``np.sort``. Timing:
CUDA events around chains of 8 calls cycling the sets (:mod:`._capacity`).
The bound counts each record read once and written once (48 bytes; 16 for the
one-key sort's 8-byte keys). One JSON line per size and variant. (The name
differs from the JAX tool's: :mod:`.sort_lab` is the radix-sort lab, the
counterpart of ``tools/pallas_sort_lab.py``.)
"""

from __future__ import annotations

import argparse
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ibu_tpu_torch.labs import _capacity as C
from ibu_tpu_torch.ops.stats import sort_records

HASH = 2654435761
UMI_MULT = 40503
SEED0 = 1000
CALLS = 8  # calls per timed chain
HINTS = {"bc_len": 16, "umi_len": 16, "index_bits": 32, "check": False}

#: name → (operands, hints, the call, bytes read and written per record)
VARIANTS = {
    "unhinted": (3, False, lambda r: sort_records(r), 48),
    "hinted": (3, True, lambda r: sort_records(r, **HINTS), 48),
    "torch.sort 1-key": (1, False, lambda r: torch.sort(r[:, 0]).values, 16),
}


def make_records(n: int, seed: int, device: torch.device) -> torch.Tensor:
    """``(n, 3)`` int64 records of the lab formula, made on ``device``."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    x = ((i * HASH) ^ (i >> 3) ^ seed) & 0xFFFFFFFF
    return torch.stack([x, (x * UMI_MULT) & 0xFFFFFF, i], dim=1)


def numpy_order(host: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The oracle of ``(n, 3)`` uint64 records: the records in
    ``np.lexsort`` order, and the barcodes by ``np.sort``."""
    return host[np.lexsort((host[:, 2], host[:, 1], host[:, 0]))], np.sort(host[:, 0])


def check(inputs: list[torch.Tensor]) -> None:
    """Every variant's output on every input against numpy, exactly (the
    numpy sorts of the inputs run in threads, side by side)."""
    hosts = [r.cpu().numpy().view(np.uint64) for r in inputs]
    with ThreadPoolExecutor(len(hosts)) as pool:
        wants = list(pool.map(numpy_order, hosts))
    for records, (want, want_keys) in zip(inputs, wants):
        for name, (_, _, fn, _) in VARIANTS.items():
            got = fn(records).cpu().numpy().view(np.uint64)
            expect = want_keys if got.ndim == 1 else want
            C.require(np.array_equal(got, expect),
                      f"{name} of {len(want)} records equals numpy's order")


def run(device, sizes, sets: int, reps: int) -> list[dict]:
    out = []
    for n in sizes:
        C.log(f"sort_keys_lab: {C.device_name(device)}, {sets} sets of {n} records")
        inputs = [make_records(n, SEED0 + s, device) for s in range(sets)]
        check(inputs)
        C.log("  oracle ok")
        for name, (operands, hinted, fn, per_record) in VARIANTS.items():
            def prepare(kk, fn=fn):
                return lambda: [fn(inputs[i % sets]) for i in range(kk)]

            times = C.chain_times(prepare, (CALLS,), reps, device)
            line = {
                "variant": name,
                "operands": operands,
                "hints": hinted,
                "records": n,
                "sets": sets,
                "best_ms": times and times["best_ms"],
                "median_ms": times and times["median_ms"],
                **C.rates(times, n, n * per_record // 2, n * per_record, device),
            }
            line["ms_per_Mrec"] = line["per_batch_ms"] and line["per_batch_ms"] * 1e6 / n
            if times:
                C.log(f"  {name}: {line['per_batch_ms']:.4f} ms, {line['Mrec_s']:.0f} Mrec/s, "
                      f"{line['pct_of_bound']:.1f}% of the bound")
            out.append(line)
        del inputs
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ibu_tpu_torch.labs.sort_keys_lab",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--records", type=int, nargs="+", default=[1 << 20, 1 << 24])
    ap.add_argument("--sets", type=int, default=4, help="distinct input sets (seeds 1000, ...)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu: the checks, no timing")
    args = ap.parse_args(argv)
    device = C.lab_device(args.device, ap.prog)
    if device is None:
        return 2
    for line in run(device, args.records, args.sets, args.reps):
        C.emit(line, device, C.EVENTS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
