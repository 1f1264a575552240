"""``pipelines.encode_sorted_file(path, bc_rows, umi_rows)`` on a batch of
ASCII barcode and UMI rows, the index left as read numbers, cycling over the
traffic's distinct batches; each distinct batch is written over a file of
its own, so a run keeps as many files as it has batches. A job's output is
the written file read back: its header's fields and its records.

Compared exactly: every record against the reference's packer and unsigned
lexicographic sort on (barcode, umi, index), and the header's sorted flag and
widths.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from portbench.jobs import rows_wrong
from portbench.reference import plain
from portbench.traffic import generate

LIMITS = {"records_wrong": 0, "header_wrong": 0}

#: the format's 32-byte header: magic, version, bc_len, umi_len, flags
#: (bit 0: sorted), 8 reserved bytes
HEADER = struct.Struct("<IIIIQ8x")


def prepare(ctx: dict) -> dict:
    cfg, p = ctx["cfg"], ctx["params"]
    n, nb = p["batch_records"], p["batches"]
    reads = generate.sample(cfg, n * nb, ctx["seed"])
    bc_len, umi_len = cfg["bc_len"], cfg["umi_len"]
    return {
        "records_per_job": n,
        "distinct": nb,
        "bc_len": bc_len,
        "umi_len": umi_len,
        "bc_rows": [generate.ascii_rows(reads["barcode"][k * n:(k + 1) * n], bc_len) for k in range(nb)],
        "umi_rows": [generate.ascii_rows(reads["umi"][k * n:(k + 1) * n], umi_len) for k in range(nb)],
        "paths": [os.path.join(ctx["workdir"], f"{ctx['cell']}.{k}.ibu") for k in range(nb)],
    }


def read_back(path: str) -> dict:
    """The file at ``path``: its header's fields and its ``(N, 3)`` uint64
    records."""
    with open(path, "rb") as f:
        _, _, bc_len, umi_len, flags = HEADER.unpack(f.read(HEADER.size))
        records = np.fromfile(f, dtype="<u8")
    return {"sorted": flags & 1, "bc_len": bc_len, "umi_len": umi_len,
            "records": records.reshape(-1, 3)}


def run(state: dict, i: int) -> dict:
    from ibu_tpu_torch import pipelines

    k = i % state["distinct"]
    with state["span"]("encode_sorted_file"):
        pipelines.encode_sorted_file(state["paths"][k], state["bc_rows"][k], state["umi_rows"][k],
                                     device=state["device"])
    return {**read_back(state["paths"][k]), "k": k}


def reference(state: dict) -> list[np.ndarray]:
    return [plain.sort(plain.records(plain.pack(bc), plain.pack(umi),
                                     np.arange(len(bc), dtype=np.uint64)))
            for bc, umi in zip(state["bc_rows"], state["umi_rows"])]


def compare(state: dict, ref: list[np.ndarray], kept) -> dict:
    out = dict.fromkeys(LIMITS, 0)
    for _, got in kept:
        out["records_wrong"] += rows_wrong(got["records"], ref[got["k"]])
        out["header_wrong"] += ((got["sorted"] != 1) + (got["bc_len"] != state["bc_len"])
                                + (got["umi_len"] != state["umi_len"]))
    return out


def control(state: dict) -> list:
    """A sort on (barcode, index), the UMI left out of the key: reads of one
    barcode stay in read order whatever their UMIs."""
    out = []
    for k, (bc, umi) in enumerate(zip(state["bc_rows"], state["umi_rows"])):
        w = plain.records(plain.pack(bc), plain.pack(umi), np.arange(len(bc), dtype=np.uint64))
        out.append((k, {"sorted": 1, "bc_len": state["bc_len"], "umi_len": state["umi_len"],
                        "records": w[np.lexsort((w[:, 2], w[:, 0]))], "k": k}))
    return out
