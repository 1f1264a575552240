"""Each job's comparison passes on the port's output at a small size on the
CPU and fails on one flipped bit of it; each control fails it."""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

from _small import CELLS, SEED, SMALL, bench, run_small

from portbench.controls import control_readings
from portbench.harness import cell_metrics, cell_spec, load_module


def _job_state(cell: str, tmp_path):
    spec = cell_spec(bench(), cell)
    cfg = {**spec["cfg"], **SMALL["cfg"]}
    params = {**spec["params"], **SMALL["params"]}
    job = load_module("jobs", params["job"])
    state = job.prepare({"cfg": cfg, "params": params, "seed": SEED, "cell": cell,
                         "workdir": str(tmp_path)})
    state.update(device=torch.device("cpu"), span=lambda name: contextlib.nullcontext())
    return job, state


def _flip_one_bit(job_name: str, out):
    if job_name == "roundtrip":
        out[1]["umi"][3] ^= np.uint64(1)
    elif job_name == "sort":
        out[1]["index"][5] ^= np.uint64(1)
    elif job_name == "stream_stats":
        out["barcode_sum"] ^= 1
    else:
        key = next(iter(out))
        out[key] ^= 1
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_comparison_passes_on_the_port_and_fails_on_a_flipped_bit(cell, tmp_path):
    job, state = _job_state(cell, tmp_path)
    ref = job.reference(state)
    out = job.run(state, 0)
    assert all(v == 0 for v in job.compare(state, ref, [(0, out)]).values())
    found = job.compare(state, ref, [(0, _flip_one_bit(cell_spec(bench(), cell)["params"]["job"], out))])
    assert any(found[k] > job.LIMITS[k] for k in job.LIMITS)


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_is_correct_and_reports_the_cells_metrics(cell):
    result, checks = run_small(cell)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    # on the CPU the metrics of the card's trace have nothing to read
    assert set(result["metrics"]) == {m["name"] for m in cell_metrics(bench(), cell, False)
                                      if m["source"] == "host_clock"}
    assert "setup_s" in result["metrics"]
    assert list(result)[-1] == "checks" and checks["jobs_compared"][0] >= 1
    assert all(v == 0 for k, (v, lim) in checks.items() if lim is not None)


#: the sort's control reorders records of one barcode and UMI that differ in
#: their index only, so its batches are made large enough to hold such pairs
CONTROL_SIZES = {"cfg": SMALL["cfg"], "params": {**SMALL["params"], "batch_records": 1 << 17,
                                                  "batches": 2}}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [SEED, 11])
def test_the_control_fails_the_comparison(cell, seed):
    readings = control_readings(bench(), cell, seed, CONTROL_SIZES)
    assert any(v > lim for v, lim in readings.values()), readings
