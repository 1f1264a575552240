"""SPLiT-seq-shaped records on the port's histogram engines and file path, on
the CPU at a small size.

The records come from the benchmark's generator with the ``splitseq``
configuration scaled down: 24-base barcodes, whose bits reach the hi word,
so every batch takes the 64-bit key path, and 10-base UMIs. A device table
of 128 slots holds a fraction of the file's barcodes, so the spill lane
carries the rest. Counts are compared exactly with the plain torch
reference (``portbench/plain_torch.py``) and the numpy one
(``portbench.reference.plain.counts``); the spans and counters of
:mod:`ibu_tpu_torch.utils.trace` are read under a CPU profiler.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from ibu_tpu_torch import Header, MmapReader, Writer, make_records
from ibu_tpu_torch import pipelines as TPL
from ibu_tpu_torch.ops.u64 import wire_view
from ibu_tpu_torch.parallel import device as TD
from ibu_tpu_torch.utils import trace
from portbench import plain_torch
from portbench.reference import plain
from portbench.traffic import generate

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]
#: the cell's table and batch settings, scaled down with the sample: every
#: 2048-read batch holds under 1024 distinct barcodes, the file about 1,400
SMALL = {"reads": 40_000, "cells": 300, "ambient_barcodes": 700}
BATCH = 2048
SPILL_KW = dict(capacity=128, max_uniques_per_shard=1024, merge_every=2)
#: spill off: a table that holds every barcode of the file
NO_SPILL_KW = dict(capacity=1 << 14, max_uniques_per_shard=1024, merge_every=2)
SEED = 2**31 + 1919


def splitseq_records(seed: int = SEED, sort: bool = False) -> np.ndarray:
    cfg = json.loads((ROOT / "portbench" / "configs" / "splitseq.json").read_text())
    records = generate.structured(generate.sample({**cfg, **SMALL}, SMALL["reads"], seed))
    if sort:
        records = np.sort(records, order=("barcode", "umi", "index"))
    return records


def references(records: np.ndarray) -> tuple[dict, dict]:
    keys, counts = plain.counts(records["barcode"])
    return plain_torch.counts_dict(records["barcode"]), dict(zip(keys.tolist(), counts.tolist()))


def traced(fn):
    """``fn()`` under a CPU profiler; its result and the spans recorded."""
    trace.session()  # ends any earlier session
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    return out, trace.session()


def spill_readings(spans) -> tuple[int, int]:
    return (sum(s.counters.get("hist_spilled_groups", 0) for s in spans),
            sum(s.name == "hist.spill" for s in spans))


def test_the_scaled_sample_has_the_cells_shape():
    """24-base barcodes past the lo word, 10-base UMIs, more barcodes than
    the table, fewer in each batch than the per-batch table."""
    records = splitseq_records()
    bc = records["barcode"]
    assert int(bc.max()) < 4**24 and int((bc >> np.uint64(32)).max()) > 0
    assert int(records["umi"].max()) < 4**10
    assert len(np.unique(bc)) > 8 * SPILL_KW["capacity"]
    batches = [records[s:s + BATCH] for s in range(0, len(records), BATCH)]
    assert max(len(np.unique(b["barcode"])) for b in batches) <= SPILL_KW["max_uniques_per_shard"]
    assert not any(TD.bc16_hint(wire_view(b)) for b in batches)


@pytest.mark.parametrize("assume_sorted", [False, True], ids=["unsorted", "sorted"])
@pytest.mark.parametrize("spill", [True, False], ids=["spill", "no_spill"])
def test_device_histogram_equals_both_references(spill, assume_sorted):
    records = splitseq_records(sort=assume_sorted)
    kw = SPILL_KW if spill else NO_SPILL_KW
    h = TD.DeviceHistogram(spill=spill, assume_sorted=assume_sorted, device=CPU, **kw)
    got, spans = traced(lambda: h.run(records[s:s + BATCH]
                                      for s in range(0, len(records), BATCH)))
    by_torch, by_numpy = references(records)
    assert got == by_torch == by_numpy
    groups, drains = spill_readings(spans)
    if spill:
        assert groups > 0 and drains > 0
        assert len(h._spilled) >= len(got) - SPILL_KW["capacity"]
    else:
        assert groups == drains == 0


@pytest.mark.parametrize("assume_sorted", [False, True], ids=["unsorted", "sorted"])
@pytest.mark.parametrize("spill", [True, False], ids=["spill", "no_spill"])
def test_stream_file_histogram_equals_both_references(spill, assume_sorted, tmp_path):
    records = splitseq_records(sort=assume_sorted)
    header = Header.new(24, 10)
    if assume_sorted:
        header.set_sorted()
    path = str(tmp_path / "splitseq.ibu")
    with Writer.from_path(path, header) as w:
        w.write_batch(records)
    kw = SPILL_KW if spill else NO_SPILL_KW
    got, spans = traced(lambda: TD.stream_file_histogram(
        MmapReader(path), CPU, batch_records=BATCH, capacity=kw["capacity"],
        max_uniques_per_shard=kw["max_uniques_per_shard"], spill=spill))
    by_torch, by_numpy = references(records)
    assert got == by_torch == by_numpy
    groups, drains = spill_readings(spans)
    assert (groups > 0 and drains > 0) if spill else (groups == drains == 0)


def test_a_spilled_barcode_seen_again_adds_its_counts():
    """Barcode 150 of 200 spills at the first merge (the table keeps the 128
    smallest keys) and comes back in the second batch: it spills again, and
    the host dict adds both merges' counts. By the merge's order a spilled
    key never re-enters the table on one rank, whose keys only get smaller:
    it re-enters the lane."""
    hi = np.uint64(1 << 40)  # 24-base barcodes reach the hi word
    first = np.arange(200, dtype=np.uint64) | hi
    second = np.arange(150, 250, dtype=np.uint64) | hi

    def batch(bc):
        return make_records(bc, np.zeros(len(bc), np.uint64), np.arange(len(bc), dtype=np.uint64))

    h = TD.DeviceHistogram(capacity=128, max_uniques_per_shard=256, merge_every=1, device=CPU)
    h.update(batch(first))
    h.update(batch(second))  # the second merge drains the first's lane
    assert h._spilled == {int(k): 1 for k in first[128:]}
    table = set(h._state["keys"][h._state["cnt"] != 0].numpy().view(np.uint64).tolist())
    assert table == {int(k) for k in first[:128]}
    got, spans = traced(h.finalize)
    assert got == plain_torch.counts_dict(np.concatenate([first, second]))
    assert all(got[int(k)] == 2 for k in range(150 | (1 << 40), 200 | (1 << 40)))
    # the finalize drains the second merge's lane: the table's 128 keys and
    # the batch's 100 make 228 groups, 100 past the table
    assert spill_readings(spans) == (100, 1)


def test_shard_overflow_names_the_cap_that_holds_the_batch():
    records = splitseq_records()[:BATCH]
    seen = len(np.unique(records["barcode"]))
    fit = 1 << (seen - 1).bit_length()
    h = TD.DeviceHistogram(capacity=1 << 14, max_uniques_per_shard=64, device=CPU)
    h.update(records)
    with pytest.raises(ValueError, match=f"saw {seen} unique barcodes.*raise the cap to {fit} "
                                         r"\(the CLI's --max-uniques\)"):
        h.finalize()
    assert fit // 2 < seen <= fit


def test_the_histogram_help_names_the_split_pool_cap(capsys):
    from ibu_tpu_torch.__main__ import main

    with pytest.raises(SystemExit):
        main(["histogram", "--help"])
    assert "need 2^19 = 524288 at 2^20-record batches" in " ".join(capsys.readouterr().out.split())


@pytest.mark.parametrize("n", [1, 3000])
def test_written_bytes_count_the_records_of_encode_sorted_file(n, tmp_path):
    rng = np.random.default_rng(n)
    bc_rows = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (n, 24))]
    umi_rows = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (n, 10))]
    path = tmp_path / "sorted.ibu"
    header, spans = traced(lambda: TPL.encode_sorted_file(str(path), bc_rows, umi_rows, device=CPU))
    written = sum(s.counters.get("written_bytes", 0) for s in spans)
    assert header.sorted() and written == path.stat().st_size - 32 == 24 * n
    assert sum(s.name == "file.write" for s in spans) == 1


def test_no_span_and_no_counter_without_a_profiler(tmp_path):
    before = trace.session()  # the last profiler session's spans, if any
    with Writer.from_path(str(tmp_path / "f.ibu"), Header.new(24, 10)) as w:
        w.write_batch(splitseq_records()[:100])
    h = TD.DeviceHistogram(device=CPU, **SPILL_KW)
    h.run([splitseq_records()[:BATCH]] * 2)
    assert trace.session() == before
