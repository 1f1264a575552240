"""Speed-of-light lab for the fused record codec on the H100.

    python -m ibu_tpu_torch.labs.sol_lab [--records N] [--variants a,b] [--block 256]
    python -m ibu_tpu_torch.labs.sol_lab --device cpu --records 4096

The Hopper counterpart of ``tools/sol_lab.py``, asking its question of this
card: how far is the codec round trip (encode then decode, 120 B per
bc16/umi12 record) from the card's copy floor, and which of encode or decode
pays? Each variant composes one encode mode and one decode mode of the lab
kernels (:mod:`ibu_tpu_torch.labs._kernels`, ``csrc/codec_lab.cu``). Every
name of the TPU lab's registry maps to one variant here; where two TPU names
ask one question on Hopper they share it:

==============  =================  ==========================================
variant         encode / decode    TPU lab names
==============  =================  ==========================================
prod            real / nib         prod, nib (the production kernels' code)
sol_touch       touch / touch      sol_touch: the copy floor
sol_reduce      reduce / reduce    sol_reduce
enc_only        real / touch       enc_only
dec_only        touch / nib        dec_only, nib_only
tree            tree / nib         tree
tree_only       tree / touch       tree_only
lut             real / lut         lut8, lut16
swar            swar / nib         e8, e16 (narrow lanes: four bases per u32)
swar_lut        swar / lut         e16lut16, e8lut8
dp4a            dp4a / nib         mxu (a pack through multiply-accumulate)
dp4a_only       dp4a / touch       mxu_only
packed          real / nib, words  packed
packed_sol      touch / touch, ws  packed_sol
==============  =================  ==========================================

The floors are the port's own (the TPU lab's touch kernels read one row of a
block that the grid pipeline moved whole; a CUDA thread moves only what it
loads): ``touch`` reads every input byte and writes every output byte with
one XOR per 8 bytes and no codec work, ``reduce`` puts every byte through a
byte max. :mod:`ibu_tpu_torch.labs._kernels` states what each writes.

Every variant is checked exactly against the host oracle before it is timed;
a failed check drops it from the table and the run exits 1. Times are CUDA
events over 3 distinct input sets, mean and min over ``--runs`` runs; there
is no in-kernel salt loop. Without a CUDA card the lab exits 2 unless given
``--device cpu``, which runs the plain versions through the checks and
prints no timing.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ibu_tpu_torch.labs import _harness as H
from ibu_tpu_torch.labs import _kernels as K
from ibu_tpu_torch.ops import codec_cuda
from ibu_tpu_torch.utils.device import select_device

#: port variant → (encode mode, decode mode, layout)
VARIANTS = {
    "prod": ("real", "nib", "sep"),
    "sol_touch": ("touch", "touch", "sep"),
    "sol_reduce": ("reduce", "reduce", "sep"),
    "enc_only": ("real", "touch", "sep"),
    "dec_only": ("touch", "nib", "sep"),
    "tree": ("tree", "nib", "sep"),
    "tree_only": ("tree", "touch", "sep"),
    "lut": ("real", "lut", "sep"),
    "swar": ("swar", "nib", "sep"),
    "swar_lut": ("swar", "lut", "sep"),
    "dp4a": ("dp4a", "nib", "sep"),
    "dp4a_only": ("dp4a", "touch", "sep"),
    "packed": ("real", "nib", "packed"),
    "packed_sol": ("touch", "touch", "packed"),
}

#: every name of ``tools/sol_lab.py``'s registry → the port variant
JAX_NAMES = {
    "prod": "prod",
    "sol_touch": "sol_touch",
    "sol_reduce": "sol_reduce",
    "enc_only": "enc_only",
    "dec_only": "dec_only",
    "nib": "prod",
    "tree": "tree",
    "tree_only": "tree_only",
    "nib_only": "dec_only",
    "lut8": "lut",
    "lut16": "lut",
    "e8": "swar",
    "e16": "swar",
    "e16lut16": "swar_lut",
    "e8lut8": "swar_lut",
    "mxu": "dp4a",
    "mxu_only": "dp4a_only",
    "packed": "packed",
    "packed_sol": "packed_sol",
}

FLOOR = "sol_touch"


def resolve(name: str) -> str:
    """A port variant name, or a TPU lab name mapped to one."""
    if name in VARIANTS:
        return name
    if name in JAX_NAMES:
        return JAX_NAMES[name]
    raise ValueError(f"unknown variant {name!r}; expected one of {', '.join(VARIANTS)} "
                     f"or a TPU lab name ({', '.join(JAX_NAMES)})")


def roundtrip(name: str, inputs: dict, block: int = 256):
    """Encode then decode one input set: ``(records, (bc, umi, index))``,
    the rows as int32 words for the packed variants."""
    enc, dec, layout = VARIANTS[name]
    if layout == "packed":
        records = K.packed_encode(inputs["bcp"], inputs["umip"], inputs["index"],
                                  sol=enc == "touch", block=block)
        return records, K.packed_decode(records, sol=dec == "touch", block=block)
    records = K.sol_encode(inputs["bc"], inputs["umi"], inputs["index"], enc, block)
    return records, K.sol_decode(records, dec, block)


def check(name: str, inputs: dict, k: int, block: int = 256) -> list[str]:
    """The variant's outputs on input set ``k`` against the host oracle over
    every record; returns what disagreed."""
    enc, dec, layout = VARIANTS[name]
    n = inputs["index"].shape[0]
    records, (bc, umi, index) = roundtrip(name, inputs, block)
    words = H.np_encode(enc, *H.period_inputs(k))
    want_bc, want_umi = H.np_decode(dec, words)
    if layout == "packed":
        want_bc, want_umi = want_bc.view("<i4"), want_umi.view("<i4")
    bad = []
    if not H.same(records[:, :2], words, n) or not H.is_arange(records[:, 2]):
        bad.append("records")
    if not H.same(bc, want_bc, n):
        bad.append("barcode rows")
    if not H.same(umi, want_umi, n):
        bad.append("UMI rows")
    if not H.is_arange(index):
        bad.append("index")
    return bad


def check_all(sets: list[dict], names: list[str], block: int = 256, log=print) -> list[str]:
    """Check every variant in ``names`` on every input set; returns the
    names that failed."""
    n = sets[0]["index"].shape[0]
    failed = []
    for name in names:
        bad = sorted({what for k, s in enumerate(sets) for what in check(name, s, k, block)})
        if bad:
            failed.append(name)
            log(f"{name}: FAILED the oracle check ({', '.join(bad)} differ)")
        else:
            log(f"{name}: oracle-exact on {len(sets)} input sets of {n} records")
    return failed


def time_all(sets: list[dict], names: list[str], runs: int = H.DEFAULT_RUNS, block: int = 256,
             failed: list[str] = ()) -> tuple[list[H.Row], list[H.Row]]:
    """Time the variants in ``names`` that are not in ``failed``,
    interleaved, the copy floor first, then each half alone
    (:func:`time_halves`). Needs a CUDA card."""
    # the floor is every row's denominator, so it is timed even when not asked for
    timed = [FLOOR] + [name for name in names if name != FLOOR and name not in failed]
    times = H.time_interleaved(
        {name: lambda s, name=name: roundtrip(name, s, block) for name in timed}, sets, runs)
    n = sets[0]["index"].shape[0]
    rows = []
    for name in timed:
        enc, dec, layout = VARIANTS[name]
        note = f"{enc}/{dec} {layout}" + (" (FAILED its check)" if name in failed else "")
        # every layout here moves the 120 counted bytes
        rows.append(H.Row(name, n, *times[name], H.USEFUL_BYTES, note))
    return rows, time_halves(sets, runs, block)


def run(device: torch.device, n: int, names: list[str], runs: int = H.DEFAULT_RUNS,
        block: int = 256, log=print) -> tuple[list[H.Row], list[H.Row], list[str]]:
    """:func:`check_all` on fresh input sets, then on a CUDA card
    :func:`time_all`. Returns the round-trip rows, the half rows and the
    names that failed their check."""
    sets = H.make_sets(n, device)
    failed = check_all(sets, names, block, log)
    if device.type != "cuda":
        return [], [], failed
    return (*time_all(sets, names, runs, block, failed), failed)


def time_halves(sets: list[dict], runs: int, block: int = 256) -> list[H.Row]:
    """Encode alone and decode alone, 60 B per record each: the lab's
    production code (``real``, ``nib``) and floor (``touch``) beside the
    production kernels of :mod:`ibu_tpu_torch.ops.codec_cuda`, whose field
    lengths are kernel arguments rather than constants. Each set gains its
    ``records``."""
    for s in sets:
        s["records"] = K.sol_encode(s["bc"], s["umi"], s["index"], "real", block)
    steps = {
        "encode touch": lambda s: K.sol_encode(s["bc"], s["umi"], s["index"], "touch", block),
        "encode real": lambda s: K.sol_encode(s["bc"], s["umi"], s["index"], "real", block),
        "encode_records": lambda s: codec_cuda.encode_records(s["bc"], s["umi"], s["index"]),
        "decode touch": lambda s: K.sol_decode(s["records"], "touch", block),
        "decode nib": lambda s: K.sol_decode(s["records"], "nib", block),
        "decode_records": lambda s: codec_cuda.decode_records(s["records"], H.BC, H.UMI),
    }
    times = H.time_interleaved(steps, sets, runs)
    n = sets[0]["index"].shape[0]
    half = H.USEFUL_BYTES // 2
    return [H.Row(name, n, *times[name], half, useful=half) for name in steps]


def report(rows: list[H.Row], halves: list[H.Row]) -> list[str]:
    """The round-trip table, the copy floor line and the halves' tables
    (each half's ``sol_pct`` against its own ``touch``)."""
    lines = H.table(rows, rows[0].ms) + [H.floor_line(rows[0])]
    lines.append("each half alone (60 B per record):")
    lines += H.table(halves[:3], halves[0].ms)
    lines += H.table(halves[3:], halves[3].ms)[1:]
    return lines


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ibu_tpu_torch.labs.sol_lab",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--records", type=int, default=H.DEFAULT_RECORDS)
    ap.add_argument("--variants", default=None,
                    help="comma list of port or TPU lab variant names (default: all)")
    ap.add_argument("--block", type=int, default=256, help="threads per block")
    ap.add_argument("--runs", type=int, default=H.DEFAULT_RUNS)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu: the plain versions, oracle checks, no timing")
    args = ap.parse_args(argv)
    device = select_device(args.device, ap.prog)
    if device is None:
        return 2
    names = list(VARIANTS) if args.variants is None else list(
        dict.fromkeys(resolve(v) for v in args.variants.split(",")))
    print(f"sol_lab: {device} n={args.records} block={args.block}", flush=True)
    rows, halves, failed = run(device, args.records, names, args.runs, args.block,
                               log=lambda line: print(line, flush=True))
    if device.type != "cuda":
        print("no timing: the plain versions ran on the CPU for the oracle checks", flush=True)
    else:
        for line in report(rows, halves):
            print(line, flush=True)
    if failed:
        print(f"sol_lab: {len(failed)} variant(s) failed: {', '.join(failed)}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
