"""``pipelines.sort_batch(records, bc_len, umi_len, index_bits)`` on a batch
of unsorted records, cycling over the traffic's distinct batches; the hints
are the chemistry's widths and the traffic's index width.

Compared exactly: every position against the reference's unsigned
lexicographic sort on (barcode, umi, index).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from portbench.jobs import rows_wrong, words
from portbench.reference import plain
from portbench.traffic import generate

LIMITS = {"positions_wrong": 0}


def prepare(ctx: dict) -> dict:
    cfg, p = ctx["cfg"], ctx["params"]
    n, nb = p["batch_records"], p["batches"]
    reads = generate.sample(cfg, n * nb, ctx["seed"])
    if int(reads["index"].max()) >> p["index_bits"]:
        raise ValueError(f"an index does not fit the traffic's {p['index_bits']}-bit hint")
    return {"records_per_job": n, "distinct": nb, "bc_len": cfg["bc_len"],
            "umi_len": cfg["umi_len"], "index_bits": p["index_bits"],
            "batches": [generate.structured(reads, k * n, (k + 1) * n) for k in range(nb)]}


def run(state: dict, i: int):
    from ibu_tpu_torch import pipelines

    k = i % state["distinct"]
    with state["span"]("sort_batch"):
        return k, pipelines.sort_batch(state["batches"][k], state["bc_len"], state["umi_len"],
                                       index_bits=state["index_bits"], device=state["device"])


def reference(state: dict) -> list[np.ndarray]:
    # one thread a batch: numpy's sort lets go of the GIL, and four serial
    # 2^22-row sorts outlast a short window
    with ThreadPoolExecutor(len(state["batches"])) as pool:
        return list(pool.map(lambda b: plain.sort(words(b)), state["batches"]))


def compare(state: dict, ref: list[np.ndarray], kept) -> dict:
    return {"positions_wrong": sum(rows_wrong(words(out), ref[k]) for _, (k, out) in kept)}


def control(state: dict) -> list:
    """A sort on the (barcode, umi) key alone, stable, the index left out of
    the key: records of one barcode and UMI stay in their input order."""
    out = []
    for k, batch in enumerate(state["batches"]):
        w = words(batch)
        out.append((k, (k, w[np.lexsort((w[:, 1], w[:, 0]))])))
    return out
