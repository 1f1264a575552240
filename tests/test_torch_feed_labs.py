"""The feed labs of the port and the generator they share, against the JAX
package, on the CPU.

``ibu_tpu_torch.utils.datagen`` must write the bytes ``ibu_tpu.utils.datagen``
writes, and the stream lab's ``make_file`` the bytes and oracle of
``tools/stream_lab.py``'s (imported by path, as ``tests/test_torch_labs.py``
imports the TPU labs). Each lab's ``main`` runs its checks with ``--device
cpu`` at a tiny size and prints its JSON lines; without a card and without
that flag each of the seven labs exits 2. Every comparison is exact.
"""

import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ibu_tpu import Header as JHeader
from ibu_tpu.utils import datagen as JG
from ibu_tpu_torch import Header as THeader
from ibu_tpu_torch.labs import (
    engine_capacity_lab,
    histogram_capacity_lab,
    molcount_capacity_lab,
    put_source_lab,
    put_sweep,
    sort_keys_lab,
    stream_lab,
)
from ibu_tpu_torch.utils import datagen as TG

REPO = Path(__file__).resolve().parents[1]
LABS = (engine_capacity_lab, histogram_capacity_lab, molcount_capacity_lab, sort_keys_lab,
        stream_lab, put_sweep, put_source_lab)


@pytest.fixture(scope="module")
def tpu_stream_lab():
    """``tools/stream_lab.py``, loaded by path; the JAX compile-cache
    threshold its import sets is put back after."""
    threshold = jax.config.jax_persistent_cache_min_compile_time_secs
    spec = importlib.util.spec_from_file_location("_tpu_stream_lab",
                                                  REPO / "tools" / "stream_lab.py")
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        jax.config.update("jax_persistent_cache_min_compile_time_secs", threshold)
    return module


DATAGEN_CASES = {
    "parallel": ("parallel_fields", {}),
    "roundtrip": ("roundtrip_fields", {}),
    "parallel, sorted flag": ("parallel_fields", {"sorted_flag": True}),
    "roundtrip, bc20/umi10 header": ("roundtrip_fields", {"header": (20, 10)}),
}


@pytest.mark.parametrize("case", list(DATAGEN_CASES))
def test_datagen_writes_the_reference_bytes(case, tmp_path):
    fields, kwargs = DATAGEN_CASES[case]
    files = {}
    for name, gen, header_cls in (("jax", JG, JHeader), ("torch", TG, THeader)):
        kw = dict(kwargs)
        if "header" in kw:
            kw["header"] = header_cls.new(*kw["header"])
        files[name] = tmp_path / f"{name}.ibu"
        # a chunk that does not divide n: several writes and a ragged last one
        gen.write_patterned_file(str(files[name]), 10_007, getattr(gen, fields), chunk=4096, **kw)
    assert files["torch"].read_bytes() == files["jax"].read_bytes()
    assert files["torch"].stat().st_size == 32 + 24 * 10_007


@pytest.mark.parametrize("fields", ["parallel_fields", "roundtrip_fields"])
def test_datagen_fields_equal_the_reference(fields):
    i = np.arange(3_000_000, 3_100_000, dtype=np.uint64)
    for got, want in zip(getattr(TG, fields)(i), getattr(JG, fields)(i)):
        assert np.array_equal(got, want) and got.dtype == want.dtype


@pytest.mark.parametrize("n, salt", [(12_345, 0), (1_000_003, 7919)])
def test_stream_make_file_equals_the_reference(tpu_stream_lab, tmp_path, n, salt):
    want = tpu_stream_lab.make_file(str(tmp_path / "jax.ibu"), n, salt)
    got = stream_lab.make_file(str(tmp_path / "torch.ibu"), n, salt)
    assert got == want
    assert (tmp_path / "torch.ibu").read_bytes() == (tmp_path / "jax.ibu").read_bytes()
    records = np.fromfile(tmp_path / "torch.ibu", dtype=np.uint64, offset=32).reshape(-1, 3)
    sums = [int(records[:, f].sum(dtype=np.uint64)) for f in range(3)]
    assert sums == [got["barcode_sum"], got["umi_sum"], got["index_sum"]]


def run_main(module, argv, capsys):
    assert module.main(argv + ["--device", "cpu"]) == 0
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


def test_stream_lab_main_runs_every_phase(tmp_path, capsys):
    lines = run_main(stream_lab, ["--records", "0.03", "--reps", "2", "--batch-records", "7000",
                                  "--workdir", str(tmp_path)], capsys)
    assert [line["phase"] for line in lines] == ["transport", "engine", "breakdown", "host"]
    for line in lines:
        assert line.keys() == {"phase", "records", "bytes", "platform", "device", "timer"}
        assert (line["records"], line["device"], line["timer"]) == (30_000, "cpu", None)
    assert not list(tmp_path.iterdir()), "the lab removes its files"


def test_stream_lab_failed_oracle_prints_no_line(tmp_path, capsys, monkeypatch):
    real = stream_lab.make_file

    def lying(path, n, salt):
        return {**real(path, n, salt), "index_sum": 1}

    monkeypatch.setattr(stream_lab, "make_file", lying)
    with pytest.raises(RuntimeError, match="oracle check failed: stream_file_stats"):
        stream_lab.main(["--records", "0.01", "--reps", "1", "--phases", "t,e",
                         "--workdir", str(tmp_path), "--device", "cpu"])
    assert capsys.readouterr().out == ""
    assert not list(tmp_path.iterdir())


def test_put_sweep_main_checks_every_size(capsys):
    lines = run_main(put_sweep, ["--sizes", "0.002,0.01", "--reps", "2", "--budget-mb", "0.1"],
                     capsys)
    assert [(line["records"], line["depth"]) for line in lines] == [(2097, 1), (10485, 1)]
    assert all(line.keys() == {"records", "MB", "depth", "device", "timer"} for line in lines)


def test_put_sweep_every_put_has_distinct_bytes():
    src = put_sweep.Source(1000, np.random.default_rng(put_sweep.SEED))
    batches = [src.fresh() for _ in range(3)] + [src.fill(np.empty((1000, 3), np.int64))]
    assert len({b.tobytes() for b in batches}) == 4
    assert np.array_equal(batches[0] ^ batches[1], np.full((1000, 3), 1 ^ 2))


def test_put_source_lab_main(tmp_path, capsys):
    lines = run_main(put_source_lab, ["--batch-records", "3000", "--reps", "3",
                                      "--workdir", str(tmp_path)], capsys)
    assert lines == [{"batch_records": 3000, "MB": 0.072, "reps": 3, "device": "cpu",
                      "timer": None}]
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("lab", LABS, ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_lab_without_a_card_exits_2(lab, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert lab.main([]) == 2
    out, err = capsys.readouterr()
    assert out == ""
    assert err.splitlines() == [
        f"python -m {lab.__name__}: device cuda requested but no CUDA card is available "
        "(torch.cuda.is_available() is false); pass device=\"cpu\" to run the plain torch "
        "versions on the CPU"]
