"""Sizes a CPU test can hold, and helpers shared by the benchmark's tests."""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: the cells' shapes, scaled down: fewer reads, cells and ambient barcodes,
#: smaller batches and per-batch tables
SMALL = {
    "cfg": {"reads": 60000, "cells": 300, "ambient_barcodes": 3000},
    "params": {"batch_records": 8192, "stream_batch_records": 8192,
               "max_uniques_per_shard": 8192},
}
SEED = 2**31 + 12345
#: the ranks of a cell of more than one card at a CPU's size, each streaming
#: as many reads as :data:`SMALL`'s file holds
RANKS = 2


def bench() -> dict:
    """``BENCHMARK.json``."""
    from portbench.harness import load_json

    return load_json(ROOT / "BENCHMARK.json")


#: every cell of ``BENCHMARK.json``
CELLS = tuple(w["name"] for w in bench()["workloads"])


def small_bench() -> dict:
    """``BENCHMARK.json`` with every cell of more than one card on
    :data:`RANKS` cards."""
    b = bench()
    b["workloads"] = [{**w, "chips": RANKS} if w["chips"] > 1 else w for w in b["workloads"]]
    return b


def sizes(cell: str, base: dict = SMALL) -> dict:
    """``base`` for ``cell``; a cell of more than one card reads
    :data:`RANKS` times ``base``'s reads, as many a rank."""
    entry = next(w for w in bench()["workloads"] if w["name"] == cell)
    if entry["chips"] == 1:
        return base
    return {"cfg": base["cfg"], "params": {**base["params"], "reads": RANKS * base["cfg"]["reads"]}}


def run_small(cell: str, seed: int = SEED, seconds: float = 0.3, trace: bool = False,
              device: str = "cpu"):
    """One run of ``cell`` of :func:`small_bench` at :func:`sizes`, past
    the look for a card."""
    import torch

    from portbench.harness import run_cell

    return run_cell(small_bench(), cell, seed, seconds, trace, torch.device(device),
                    time.perf_counter(), sizes=sizes(cell))
