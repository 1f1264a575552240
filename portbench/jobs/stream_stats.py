"""``pipelines.file_stats(path, engine="device")`` over one unsorted file of
the configuration's reads, written at set-up.

Compared exactly: the count and the three sums mod 2^64 of every job in the
window, and the engine the call names.
"""

from __future__ import annotations

import os

from portbench.jobs import ibu_header
from portbench.reference import plain
from portbench.traffic import generate

LIMITS = {"fields_wrong": 0, "engine_wrong": 0}
FIELDS = ("count", "barcode_sum", "umi_sum", "index_sum")


def prepare(ctx: dict) -> dict:
    cfg = ctx["cfg"]
    n = cfg["reads"]
    records = generate.structured(generate.sample(cfg, n, ctx["seed"]))
    path = os.path.join(ctx["workdir"], f"{ctx['cell']}.ibu")
    generate.write_file(path, ibu_header(cfg["bc_len"], cfg["umi_len"]), records)
    return {"records_per_job": n, "distinct": 1, "bc_len": cfg["bc_len"],
            "umi_len": cfg["umi_len"], "records": records, "path": path}


def run(state: dict, i: int) -> dict:
    from ibu_tpu_torch import pipelines

    with state["span"]("file_stats"):
        return pipelines.file_stats(state["path"], engine="device", device=state["device"])


def reference(state: dict) -> dict:
    return plain.sums(state["records"].view("<u8").reshape(-1, 3))


def compare(state: dict, ref: dict, kept) -> dict:
    out = dict.fromkeys(LIMITS, 0)
    for _, stats in kept:
        out["fields_wrong"] += sum(stats.get(f) != ref[f] for f in FIELDS)
        out["engine_wrong"] += stats.get("engine") != "device"
    return out


def control(state: dict) -> list:
    """Sums kept in 32-bit accumulators (mod 2^32) in place of 64-bit."""
    sums = plain.sums(state["records"].view("<u8").reshape(-1, 3))
    low = {f: v & 0xFFFFFFFF if f != "count" else v for f, v in sums.items()}
    return [(0, {**low, "engine": "device"})]
