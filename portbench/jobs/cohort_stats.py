"""``parallel.multihost.multihost_file_stats(path, device)`` on every rank of
a cohort, over one unsorted file of the cell's ``reads`` written at set-up by
rank 0. Each rank streams its own contiguous record range onto its card, and
the ranks' states merge in one collective, so every rank returns the whole
file's answer.

Compared exactly: the count and the three sums mod 2^64 that each rank
returned in each kept job, against the whole file's (a rank that returned
nothing counts its four fields wrong); and the kept outputs of a rank that
differ from rank 0's. A cohort of one rank is the whole file in one process.
"""

from __future__ import annotations

import os

from portbench.jobs import ibu_header, words
from portbench.reference import plain
from portbench.traffic import generate

LIMITS = {"fields_wrong": 0, "ranks_wrong": 0}
FIELDS = ("count", "barcode_sum", "umi_sum", "index_sum")


def ranges(n: int, ranks: int) -> list[tuple[int, int]]:
    """The ranks' record ranges: contiguous, ``n // ranks`` each, the
    remainder to the last."""
    per = n // ranks
    return [(r * per, n if r == ranks - 1 else (r + 1) * per) for r in range(ranks)]


def prepare(ctx: dict) -> dict:
    cfg = ctx["cfg"]
    n = ctx["params"]["reads"]
    rank, ranks = ctx.get("rank", 0), ctx.get("ranks", 1)
    start, end = ranges(n, ranks)[rank]
    path = os.path.join(ctx["workdir"], f"{ctx['cell']}.ibu")
    state = {"records_per_job": end - start, "distinct": 1, "bc_len": cfg["bc_len"],
             "umi_len": cfg["umi_len"], "path": path, "ranks": ranks}
    if rank == 0:
        records = generate.structured(generate.sample(cfg, n, ctx["seed"]))
        generate.write_file(path, ibu_header(cfg["bc_len"], cfg["umi_len"]), records)
        state["records"] = records
    return state


def run(state: dict, i: int) -> dict:
    from ibu_tpu_torch.parallel.multihost import multihost_file_stats

    with state["span"]("multihost_file_stats"):
        return multihost_file_stats(state["path"], device=state["device"])


def reference(state: dict) -> dict:
    return plain.sums(words(state["records"]))


def compare(state: dict, ref: dict, kept) -> dict:
    out = dict.fromkeys(LIMITS, 0)
    for _, outs in kept:
        outs = outs if isinstance(outs, list) else [outs]
        out["fields_wrong"] += sum(o is None or o.get(f) != ref[f] for o in outs for f in FIELDS)
        out["ranks_wrong"] += sum(o != outs[0] for o in outs[1:])
    return out


def control(state: dict) -> list:
    """The merge with the last rank's state left out: every rank returns
    the sums of the other ranks' ranges."""
    ranks = state["ranks"]
    start, _ = ranges(len(state["records"]), ranks)[-1]
    short = plain.sums(words(state["records"][:start]))
    return [(0, [dict(short) for _ in range(ranks)])]
