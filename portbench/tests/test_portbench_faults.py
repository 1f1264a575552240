"""A run with the timed path broken underneath comes out not correct: for
each one-card cell, a step that returns its state unchanged, half of the
work left out, and an answer altered where it is produced. The runs skip
the harness's look for a card and drive the rest of a run on the CPU. The
cohort's faults, the exchange between ranks left out among them, are in
``test_portbench_ranks.py``, planted in every rank's process."""

from __future__ import annotations

import pytest
import torch

from _small import run_small

import ibu_tpu_torch.io.stream as stream_mod
import ibu_tpu_torch.ops.codec_cuda as codec_mod
import ibu_tpu_torch.ops.stats as stats_mod
import ibu_tpu_torch.parallel.device as device_mod
# bound to the engine's real fold before any fault patches it: the module
# takes STATS_MAP_REDUCE by name when it is first imported
import ibu_tpu_torch.parallel.multihost  # noqa: F401


def _flip_first(t: torch.Tensor) -> torch.Tensor:
    t = t.clone()
    t.view(-1)[0] ^= 1
    return t


def roundtrip_unchanged(mp):
    # the encode step leaves its output as allocated
    mp.setattr(codec_mod, "encode_records",
               lambda bc, umi, idx, *a, **k: torch.zeros((bc.shape[0], 3), dtype=torch.int64,
                                                         device=bc.device))


def roundtrip_half(mp):
    real = codec_mod.encode_records
    mp.setattr(codec_mod, "encode_records",
               lambda bc, umi, idx, *a, **k: real(bc[: len(bc) // 2], umi[: len(umi) // 2],
                                                  idx[: len(idx) // 2], *a, **k))


def roundtrip_altered(mp):
    real = codec_mod.encode_records
    mp.setattr(codec_mod, "encode_records", lambda *a, **k: _flip_first(real(*a, **k)))


def stats_unchanged(mp):
    mp.setattr(device_mod, "STATS_MAP_REDUCE",
               device_mod.MapReduce(init=device_mod._stats_init, update=lambda state, r: state))


def stats_half(mp):
    real = device_mod.record_batches_from_mmap
    mp.setattr(stream_mod, "record_batches_from_mmap",
               lambda *a, **k: (b[: len(b) // 2] for b in real(*a, **k)))


def stats_altered(mp):
    real = device_mod.field_sums
    mp.setattr(device_mod, "field_sums", lambda r: _flip_first(real(r)))


def sort_unchanged(mp):
    mp.setattr(stats_mod, "_sort_impl", lambda records, hi_used: records)


def sort_half(mp):
    real = stats_mod._sort_impl
    mp.setattr(stats_mod, "_sort_impl",
               lambda r, hi: torch.cat([real(r[: len(r) // 2], hi), r[len(r) // 2:]]))


def sort_altered(mp):
    real = stats_mod._sort_impl
    mp.setattr(stats_mod, "_sort_impl", lambda r, hi: _flip_first(real(r, hi)))


def hist_unchanged(mp):
    mp.setattr(device_mod.DeviceHistogram, "update_placed", lambda self, records, bc16=False: None)


def hist_half(mp):
    real = device_mod.DeviceHistogram.update_placed

    def every_other(self, records, bc16=False):
        self._calls = getattr(self, "_calls", 0) + 1
        if self._calls % 2:
            real(self, records, bc16)

    mp.setattr(device_mod.DeviceHistogram, "update_placed", every_other)


def hist_altered(mp):
    real = device_mod._masked_histogram

    def altered(records, max_uniques, bc16=False):
        keys, counts, seen = real(records, max_uniques, bc16)
        return keys, counts + (torch.arange(len(counts)) == 0).to(counts.dtype), seen

    mp.setattr(device_mod, "_masked_histogram", altered)


FAULTS = [
    ("v3.roundtrip", roundtrip_unchanged), ("v3.roundtrip", roundtrip_half),
    ("v3.roundtrip", roundtrip_altered),
    ("v3.stream_stats", stats_unchanged), ("v3.stream_stats", stats_half),
    ("v3.stream_stats", stats_altered),
    ("dropseq.sort", sort_unchanged), ("dropseq.sort", sort_half),
    ("dropseq.sort", sort_altered),
    ("dropseq.histogram", hist_unchanged), ("dropseq.histogram", hist_half),
    ("dropseq.histogram", hist_altered),
]


@pytest.mark.parametrize("cell, fault", FAULTS, ids=[f.__name__ for _, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    result, checks = run_small(cell, seconds=0.2)
    assert not result["correct"], checks


def test_the_faults_leave_a_sound_run_correct():
    for cell in sorted({c for c, _ in FAULTS}):
        assert run_small(cell, seconds=0.2)[0]["correct"]
