"""``pipelines.encode_batch`` then ``pipelines.decode_batch``, device engine,
on a batch of ASCII barcode and UMI rows with their indices, cycling over
the traffic's distinct batches.

Compared exactly: the records against the reference packer, and the
decoded rows and index against the inputs.
"""

from __future__ import annotations

import numpy as np

from portbench.jobs import rows_wrong, words
from portbench.reference import plain
from portbench.traffic import generate

LIMITS = {"records_wrong": 0, "bc_rows_wrong": 0, "umi_rows_wrong": 0, "index_wrong": 0}


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
        "index": [reads["index"][k * n:(k + 1) * n].copy() for k in range(nb)],
    }


def run(state: dict, i: int):
    from ibu_tpu_torch import pipelines

    k, span, device = i % state["distinct"], state["span"], state["device"]
    with span("encode_batch"):
        records = pipelines.encode_batch(state["bc_rows"][k], state["umi_rows"][k],
                                         state["index"][k], engine="device", device=device)
    with span("decode_batch"):
        bc, umi, index = pipelines.decode_batch(records, state["bc_len"], state["umi_len"],
                                                engine="device", device=device)
    return k, records, bc, umi, index


def reference(state: dict) -> list[np.ndarray]:
    return [plain.records(plain.pack(bc), plain.pack(umi), idx)
            for bc, umi, idx in zip(state["bc_rows"], state["umi_rows"], state["index"])]


def compare(state: dict, ref: list[np.ndarray], kept) -> dict:
    out = dict.fromkeys(LIMITS, 0)
    for _, (k, records, bc, umi, index) in kept:
        out["records_wrong"] += rows_wrong(words(records), ref[k])
        out["bc_rows_wrong"] += rows_wrong(bc, state["bc_rows"][k])
        out["umi_rows_wrong"] += rows_wrong(umi, state["umi_rows"][k])
        out["index_wrong"] += rows_wrong(np.asarray(index, dtype=np.uint64), state["index"][k])
    return out


#: the control's code table: the ASCII shortcut ``(c >> 1) & 3`` without
#: the step that puts G and T in the format's order (G=11, T=10)
SHORTCUT_CODE = np.zeros(256, dtype=np.uint8)
SHORTCUT_CODE[[ord(c) for c in "ACGT"]] = [(ord(c) >> 1) & 3 for c in "ACGT"]


def control(state: dict) -> list:
    """A codec that breaks the format's table but stays lossless: its
    records swap G and T, and its decoder, the inverse, gives the rows back."""
    out = []
    for k in range(state["distinct"]):
        bc, umi, idx = state["bc_rows"][k], state["umi_rows"][k], state["index"][k]
        recs = plain.records(plain.pack(bc, SHORTCUT_CODE), plain.pack(umi, SHORTCUT_CODE), idx)
        structured = recs.view([("barcode", "<u8"), ("umi", "<u8"), ("index", "<u8")]).reshape(-1)
        out.append((k, (k, structured, plain.unpack(recs[:, 0], state["bc_len"], b"ACTG"),
                        plain.unpack(recs[:, 1], state["umi_len"], b"ACTG"), recs[:, 2].copy())))
    return out
