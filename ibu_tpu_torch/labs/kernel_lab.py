"""Layout lab for the fused record codec on the H100.

    python -m ibu_tpu_torch.labs.kernel_lab [--records N] [--blocks 128,256,512]
        [--variants sep3sep,comb4comb,...]
    python -m ibu_tpu_torch.labs.kernel_lab --device cpu --records 4096

The Hopper counterpart of ``tools/kernel_lab.py``: the production codec
(``pack_row`` / ``unpack_row`` from ``csrc/codec_device.cuh``) under every
combination of the GPU's layout axes, one table row each, with the same
columns as :mod:`ibu_tpu_torch.labs.sol_lab` and its ``sol_pct`` against a
``sol_touch`` copy floor timed in the same process.

- enc-in ``sep``: ``(N, 16)`` + ``(N, 12)`` uint8 rows, read as production
  reads them (4-byte words); ``comb``: one ``(N, 32)`` row, bases 28-31 'A'
  padding, read as two 16-byte vectors. Does a 32-byte row that allows
  16-byte loads beat two rows of 16 and 12 bytes?
- records ``3``: ``(N, 3)`` int64, 24 B, as in production; ``4``: ``(N, 4)``
  with a zero word, 32 B, stored and loaded as two 16-byte vectors (the TPU
  lab's soa 6 against 8).
- dec-out ``sep`` or ``comb`` (bases 28-31 written 'A'), as enc-in.
- ``--blocks``: threads per block, in place of the TPU lab's ``--tiles``;
  production uses 256.

``sep3sep/b256`` is the sanity row: the production device code, timed beside
the ``production`` row, the kernels ``encode_records`` + ``decode_records``
themselves (:mod:`ibu_tpu_torch.ops.codec_cuda`). GB/s counts
the TPU lab's 120 B per record whatever the layout; the bytes a layout
really moves are beside it. Checks, exit codes and ``--device cpu`` are as
in :mod:`ibu_tpu_torch.labs.sol_lab`.
"""

from __future__ import annotations

import argparse
import itertools
import sys

import numpy as np
import torch

from ibu_tpu_torch.labs import _harness as H
from ibu_tpu_torch.labs import _kernels as K
from ibu_tpu_torch.labs import sol_lab
from ibu_tpu_torch.ops import codec_cuda
from ibu_tpu_torch.utils.device import select_device

#: (enc-in, record words, dec-out), named like ``sep3sep``
COMBOS = list(itertools.product(("sep", "comb"), (3, 4), ("sep", "comb")))
DEFAULT_BLOCKS = (128, 256, 512)
#: the reference row: the production kernels themselves
PRODUCTION = "production"


def combo_name(combo: tuple[str, int, str]) -> str:
    return "".join(map(str, combo))


def roundtrip(combo: tuple[str, int, str], inputs: dict, block: int = 256):
    """Encode then decode one input set: ``(records, decoded)``; decoded is
    ``(bc, umi, index)`` or ``(comb, index)``."""
    enc_in, cols, dec_out = combo
    rows = (inputs["bc"], inputs["umi"]) if enc_in == "sep" else (inputs["comb"],)
    records = K.layout_encode(rows, inputs["index"], cols, block)
    return records, K.layout_decode(records, dec_out == "comb", block)


def moved_bytes(combo: tuple[str, int, str]) -> int:
    """Bytes moved per record: ASCII and index in, the record written and
    read back, ASCII and index out."""
    enc_in, cols, dec_out = combo
    ascii_in = H.COMB if enc_in == "comb" else H.BC + H.UMI
    ascii_out = H.COMB if dec_out == "comb" else H.BC + H.UMI
    return ascii_in + 8 + 2 * 8 * cols + ascii_out + 8


def check(combo: tuple[str, int, str], inputs: dict, k: int, block: int = 256) -> list[str]:
    """The combination's outputs on input set ``k`` against the host oracle
    over every record; returns what disagreed."""
    n = inputs["index"].shape[0]
    records, decoded = roundtrip(combo, inputs, block)
    bc, umi = H.period_inputs(k)
    words = H.np_encode("real", bc, umi)
    bad = []
    if not H.same(records[:, :2], words, n) or not H.is_arange(records[:, 2]):
        bad.append("records")
    if combo[1] == 4 and bool((records[:, 3] != 0).any()):
        bad.append("zero word")
    want_bc, want_umi = H.np_decode("nib", words)
    if combo[2] == "comb":
        pad = np.full((H.PERIOD, H.COMB - H.BC - H.UMI), 65, np.uint8)
        if not H.same(decoded[0], np.concatenate([want_bc, want_umi, pad], axis=1), n):
            bad.append("combined rows")
    else:
        if not H.same(decoded[0], want_bc, n):
            bad.append("barcode rows")
        if not H.same(decoded[1], want_umi, n):
            bad.append("UMI rows")
    if not H.is_arange(decoded[-1]):
        bad.append("index")
    return bad


def check_all(sets: list[dict], blocks=DEFAULT_BLOCKS, combos=COMBOS, log=print) -> list[str]:
    """Check every (combination, block) on every input set; returns the
    names that failed."""
    n = sets[0]["index"].shape[0]
    failed = []
    for block in blocks:
        for combo in combos:
            name = f"{combo_name(combo)}/b{block}"
            bad = sorted({w for k, s in enumerate(sets) for w in check(combo, s, k, block)})
            if bad:
                failed.append(name)
                log(f"{name}: FAILED the oracle check ({', '.join(bad)} differ)")
            else:
                log(f"{name}: oracle-exact on {len(sets)} input sets of {n} records")
    return failed


def time_all(sets: list[dict], blocks=DEFAULT_BLOCKS, combos=COMBOS, runs: int = H.DEFAULT_RUNS,
             failed: list[str] = ()) -> list[H.Row]:
    """Time the copy floor, the production kernels and every (combination,
    block) not in ``failed``, interleaved; the floor's row comes first.
    Needs a CUDA card."""
    steps = {sol_lab.FLOOR: lambda s: sol_lab.roundtrip(sol_lab.FLOOR, s),
             PRODUCTION: lambda s: codec_cuda.decode_records(
                 codec_cuda.encode_records(s["bc"], s["umi"], s["index"]), H.BC, H.UMI)}
    moved = {}
    for block in blocks:
        for combo in combos:
            name = f"{combo_name(combo)}/b{block}"
            if name not in failed:
                steps[name] = lambda s, c=combo, b=block: roundtrip(c, s, b)
                moved[name] = moved_bytes(combo)
    times = H.time_interleaved(steps, sets, runs)
    n = sets[0]["index"].shape[0]
    rows = [H.Row(sol_lab.FLOOR, n, *times[sol_lab.FLOOR], H.USEFUL_BYTES, "touch/touch sep, b256"),
            H.Row(PRODUCTION, n, *times[PRODUCTION], H.USEFUL_BYTES,
                  "encode_records + decode_records, b256")]
    return rows + [H.Row(name, n, *times[name], moved[name]) for name in moved]


def run(device: torch.device, n: int, blocks=DEFAULT_BLOCKS, combos=COMBOS,
        runs: int = H.DEFAULT_RUNS, log=print) -> tuple[list[H.Row], list[str]]:
    """:func:`check_all` on fresh input sets, then on a CUDA card
    :func:`time_all`. Returns the timed rows, the floor first, and the names
    that failed their check."""
    sets = H.make_sets(n, device)
    failed = check_all(sets, blocks, combos, log)
    if device.type != "cuda":
        return [], failed
    return time_all(sets, blocks, combos, runs, failed), failed


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ibu_tpu_torch.labs.kernel_lab",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--records", type=int, default=H.DEFAULT_RECORDS)
    ap.add_argument("--blocks", default=",".join(map(str, DEFAULT_BLOCKS)),
                    help="threads per block, comma list")
    ap.add_argument("--variants", default=None,
                    help="comma list like sep3sep,comb4comb (default: all 8)")
    ap.add_argument("--runs", type=int, default=H.DEFAULT_RUNS)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu: the plain versions, oracle checks, no timing")
    args = ap.parse_args(argv)
    device = select_device(args.device, ap.prog)
    if device is None:
        return 2
    blocks = [int(b) for b in args.blocks.split(",")]
    combos = COMBOS
    if args.variants:
        known = {combo_name(c): c for c in COMBOS}
        unknown = [v for v in args.variants.split(",") if v not in known]
        if unknown:
            ap.error(f"unknown variants {unknown}; expected some of {', '.join(known)}")
        combos = [known[v] for v in dict.fromkeys(args.variants.split(","))]
    print(f"kernel_lab: {device} n={args.records} blocks={blocks}", flush=True)
    rows, failed = run(device, args.records, blocks, combos, args.runs,
                       log=lambda line: print(line, flush=True))
    if device.type != "cuda":
        print("no timing: the plain versions ran on the CPU for the oracle checks", flush=True)
    else:
        for line in H.table(rows, rows[0].ms):
            print(line, flush=True)
        print(H.floor_line(rows[0]), flush=True)
    if failed:
        print(f"kernel_lab: {len(failed)} variant(s) failed: {', '.join(failed)}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
