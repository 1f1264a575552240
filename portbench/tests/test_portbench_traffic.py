"""The generator against its configurations, and the per-batch table size
of ``dropseq.histogram``."""

from __future__ import annotations

import json

import numpy as np
import pytest

from _small import ROOT

from portbench.harness import cell_spec
from portbench.reference import plain
from portbench.traffic import generate

from _small import bench


def _cfg(name: str) -> dict:
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["chromium3p_v3", "dropseq"])
def test_reads_meet_the_configuration(name):
    cfg = _cfg(name)
    n = 400_000
    reads = generate.sample(cfg, n, 2**31 + 99)
    bc, umi, idx = reads["barcode"], reads["umi"], reads["index"]
    assert len(bc) == len(umi) == len(idx) == n
    assert int(bc.max()) < 4 ** cfg["bc_len"] and int(umi.max()) < 4 ** cfg["umi_len"]
    assert int(idx.max()) < cfg["genes"]
    # the sample's barcodes are redrawn; reads that match none carry an error
    again = generate.sample(cfg, n, 2**31 + 99)
    assert all(np.array_equal(reads[k], again[k]) for k in reads)
    rng = generate.rng_for(2**31 + 99)
    drawn = generate._distinct_words(rng, cfg["cells"] + cfg["ambient_barcodes"], cfg["bc_len"])
    cells, ambient = drawn[:cfg["cells"]], drawn[cfg["cells"]:]
    on_ambient = np.isin(bc, ambient).mean()
    on_cells = np.isin(bc, cells).mean()
    errors = 1 - on_ambient - on_cells
    rate = cfg["barcode_error_rate"]
    assert abs(on_ambient - cfg["ambient_read_share"] * (1 - rate)) < 0.01
    assert abs(errors - rate) < 0.002
    assert len(np.unique(cells)) == cfg["cells"] and not np.isin(cells, ambient).any()
    # about reads_per_molecule reads a molecule: distinct molecules seen are
    # n / r * (1 - e^-r) for Poisson draws of mean r
    mol = len(np.unique(np.stack([bc, umi, idx], axis=1), axis=0))
    r = cfg["reads_per_molecule"]
    assert abs(mol / (n / r * (1 - np.exp(-r))) - 1) < 0.03
    rows = generate.ascii_rows(bc[:1000], cfg["bc_len"])
    assert np.array_equal(rows, plain.unpack(bc[:1000], cfg["bc_len"]))


def test_different_seeds_give_different_reads():
    cfg = _cfg("dropseq")
    a, b = generate.sample(cfg, 10_000, 1), generate.sample(cfg, 10_000, 2)
    assert not np.array_equal(a["barcode"], b["barcode"])


def test_dropseq_histogram_table_holds_every_batch():
    """``max_uniques_per_shard`` is the least power of two over the most
    distinct barcodes in any stream batch of the cell's file."""
    spec = cell_spec(bench(), "dropseq.histogram")
    m, batch = spec["params"]["max_uniques_per_shard"], spec["params"]["stream_batch_records"]
    most = 0
    for seed in (3, 2**31 + 5):
        bc = generate.sample(spec["cfg"], spec["cfg"]["reads"], seed)["barcode"]
        most = max(most, max(len(np.unique(bc[s:s + batch])) for s in range(0, len(bc), batch)))
    assert m // 2 < most <= m
    assert most > 100_000
