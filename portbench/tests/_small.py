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


def bench() -> dict:
    """``BENCHMARK.json``."""
    from portbench.harness import load_json

    return load_json(ROOT / "BENCHMARK.json")


#: every cell of ``BENCHMARK.json``
CELLS = tuple(w["name"] for w in bench()["workloads"])


def run_small(cell: str, seed: int = SEED, seconds: float = 0.3, trace: bool = False,
              device: str = "cpu"):
    """One run of ``cell`` at :data:`SMALL` sizes, past the look for a card."""
    import torch

    from portbench.harness import run_cell

    return run_cell(bench(), cell, seed, seconds, trace, torch.device(device),
                    time.perf_counter(), sizes=SMALL)
