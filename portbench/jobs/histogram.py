"""``parallel.device.stream_file_histogram(MmapReader(path), device,
capacity, max_uniques_per_shard)`` over one unsorted file of the
configuration's reads, written at set-up.

Compared exactly: every barcode's count, a barcode missing on one side
counting as wrong.
"""

from __future__ import annotations

import os

import numpy as np

from portbench.jobs import ibu_header
from portbench.reference import plain
from portbench.traffic import generate

LIMITS = {"barcodes_wrong": 0}


def prepare(ctx: dict) -> dict:
    cfg, p = ctx["cfg"], ctx["params"]
    n = cfg["reads"]
    records = generate.structured(generate.sample(cfg, n, ctx["seed"]))
    path = os.path.join(ctx["workdir"], f"{ctx['cell']}.ibu")
    generate.write_file(path, ibu_header(cfg["bc_len"], cfg["umi_len"]), records)
    return {"records_per_job": n, "distinct": 1, "bc_len": cfg["bc_len"],
            "umi_len": cfg["umi_len"], "records": records, "path": path,
            "batch_records": p["stream_batch_records"], "capacity": p["capacity"],
            "max_uniques": p["max_uniques_per_shard"]}


def run(state: dict, i: int) -> dict:
    from ibu_tpu_torch.io.mmap import MmapReader
    from ibu_tpu_torch.parallel.device import stream_file_histogram

    with state["span"]("stream_file_histogram"):
        return stream_file_histogram(
            MmapReader(state["path"]), state["device"], batch_records=state["batch_records"],
            capacity=state["capacity"], max_uniques_per_shard=state["max_uniques"])


def reference(state: dict) -> tuple[np.ndarray, np.ndarray]:
    return plain.counts(state["records"]["barcode"])


def barcodes_wrong(hist: dict, keys: np.ndarray, counts: np.ndarray) -> int:
    got_k = np.fromiter(hist.keys(), dtype=np.uint64, count=len(hist))
    got_c = np.fromiter(hist.values(), dtype=np.int64, count=len(hist))
    every = np.union1d(got_k, keys)
    got = np.zeros(len(every), dtype=np.int64)
    want = np.zeros(len(every), dtype=np.int64)
    got[np.searchsorted(every, got_k)] = got_c
    want[np.searchsorted(every, keys)] = counts
    return int((got != want).sum())


def compare(state: dict, ref, kept) -> dict:
    keys, counts = ref
    return {"barcodes_wrong": sum(barcodes_wrong(h, keys, counts) for _, h in kept)}


def control(state: dict) -> list:
    """A keyless table of ``capacity`` slots, indexed by the barcode's low
    bits: each barcode reads the count of its slot, which barcodes that
    share the slot add to."""
    bc = state["records"]["barcode"]
    slot = (bc & np.uint64(state["capacity"] - 1)).astype(np.intp)
    table = np.bincount(slot, minlength=state["capacity"])
    keys = np.unique(bc)
    return [(0, dict(zip(keys.tolist(), table[(keys & np.uint64(state["capacity"] - 1)).astype(np.intp)].tolist())))]
