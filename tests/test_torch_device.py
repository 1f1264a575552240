"""The port needs a CUDA card unless the caller asks for the CPU by name.

``torch.cuda.is_available`` is patched to ``False`` in every test, so they
read the same on a machine with a card. ``None`` (every entry point's
default) means the card: without one it raises, naming ``device="cpu"``,
and never runs on the CPU in its place. The commands exit 2 without
``--device cpu``.
"""

import os
from unittest import mock

import numpy as np
import pytest
import torch

from ibu_tpu_torch import Header, MmapReader, Writer, make_records, native
from ibu_tpu_torch import pipelines as PL
from ibu_tpu_torch import validate as V
from ibu_tpu_torch.data import RecordLoader
from ibu_tpu_torch.errors import NO_CARD_HINT, NoCardError
from ibu_tpu_torch.examples import fastq_ingest as FI
from ibu_tpu_torch.examples import roundtrip as RT
from ibu_tpu_torch.examples import workflow as W
from ibu_tpu_torch.io.stream import DeviceStream
from ibu_tpu_torch.ops import correct as TC
from ibu_tpu_torch.ops import knee as TK
from ibu_tpu_torch.parallel import device as D
from ibu_tpu_torch.parallel import multihost as MH
from ibu_tpu_torch.parallel import select as SEL
from ibu_tpu_torch.parallel import sort as MS
from ibu_tpu_torch.utils.device import resolve_device, select_device


@pytest.fixture(autouse=True)
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("IBU_AUTO_ENGINE", raising=False)
    SEL.reset_probe_memo()
    yield
    SEL.reset_probe_memo()


@pytest.fixture
def ibu_file(tmp_path):
    i = np.arange(64, dtype=np.uint64)
    path = str(tmp_path / "small.ibu")
    with Writer.from_path(path, Header.new(16, 12)) as w:
        w.write_batch(make_records(i * np.uint64(7), i, i))
    return path


def test_none_raises_and_names_the_cpu():
    with pytest.raises(NoCardError, match='no CUDA card is available') as err:
        resolve_device(None)
    assert isinstance(err.value, RuntimeError)
    assert 'device="cpu"' in str(err.value)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device()


@pytest.mark.parametrize("device", ["cuda", "cuda:0", torch.device("cuda")])
def test_an_explicit_card_raises(device):
    with pytest.raises(NoCardError, match="requested but no CUDA card is available"):
        resolve_device(device)


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")])
def test_only_the_cpu_by_name_gives_the_cpu(device):
    assert resolve_device(device) == torch.device("cpu")


def test_other_devices_are_refused():
    with pytest.raises(ValueError, match="unsupported device meta"):
        resolve_device("meta")


def test_select_device_for_commands(capsys):
    assert select_device(None, "prog") is None
    assert "prog: no CUDA card" in capsys.readouterr().out
    assert select_device("cuda", "prog") is None
    assert "requested but no CUDA card" in capsys.readouterr().out
    assert select_device("cpu", "prog") == torch.device("cpu")


def test_validate_without_a_card_exits_2(tmp_path, capsys, monkeypatch):
    ran = []
    monkeypatch.setattr(V, "run_matrix", lambda *a, **k: ran.append(1) or [])
    out = tmp_path / "v.json"
    assert V.main(["--out", str(out)]) == 2
    printed = capsys.readouterr().out
    assert "no CUDA card" in printed and "--device cpu" in printed
    assert V.main(["--device", "cuda", "--out", str(out)]) == 2
    assert not ran and not out.exists()


def records_of(path):
    return np.asarray(MmapReader(path).records)


ROWS = np.full((4, 16), ord("A"), np.uint8)
#: every entry point of the port that takes ``device``, called without it
ENTRY_POINTS = {
    "encode_batch": lambda p: PL.encode_batch(ROWS, ROWS[:, :12], np.arange(4, dtype=np.uint64)),
    "decode_batch": lambda p: PL.decode_batch(records_of(p), 16, 12, engine="device"),
    "sort_batch": lambda p: PL.sort_batch(records_of(p)),
    "encode_sorted_file": lambda p: PL.encode_sorted_file(p + ".out", ["ACGT"], ["ACGT"]),
    "decode_file": lambda p: PL.decode_file(p),
    "file_stats": lambda p: PL.file_stats(p, engine="device"),
    "barcode_counts": lambda p: PL.barcode_counts(p, engine="device"),
    "sharded_stats": lambda p: D.sharded_stats(records_of(p)),
    "stream_file_stats": lambda p: D.stream_file_stats(MmapReader(p)),
    "STATS_MAP_REDUCE.run": lambda p: D.STATS_MAP_REDUCE.run(iter([records_of(p)])),
    "DeviceHistogram": lambda p: D.DeviceHistogram(),
    "sharded_barcode_histogram": lambda p: D.sharded_barcode_histogram(iter([records_of(p)])),
    "stream_file_histogram": lambda p: D.stream_file_histogram(MmapReader(p)),
    "DeviceStream": lambda p: DeviceStream(iter([records_of(p)])),
    "run_matrix": lambda p: V.run_matrix(),
    "write_artifact": lambda p: V.write_artifact(p + ".json", []),
    "sort_file_device": lambda p: PL.sort_file_device(p, p + ".sorted"),
    "dedup_file unsorted": lambda p: without_native(PL.dedup_file, p, p + ".dedup"),
    "count_matrix device": lambda p: PL.count_matrix(p, p + ".m", engine="device"),
    "call_cells device": lambda p: PL.call_cells(p, p + ".txt", engine="device"),
    "correct_file": lambda p: PL.correct_file(p, p + ".fixed", [7, 14]),
    "correct_batch": lambda p: TC.correct_batch(records_of(p)["barcode"], np.array([7], np.uint64), 16),
    "torch_knee_index": lambda p: TK.torch_knee_index(np.array([9, 5, 1])),
    "decode_batch auto": lambda p: PL.decode_batch(records_of(p), 16, 12),
    "file_stats auto": lambda p: PL.file_stats(p),
    "export_fastq": lambda p: PL.export_fastq(p, p + ".fastq"),
    "ingest_fastq": lambda p: PL.ingest_fastq(fastq_of(p), p + ".back", 16, 12),
    "auto_codec_engine": lambda p: SEL.auto_codec_engine(),
    "auto_stats_engine": lambda p: SEL.auto_stats_engine(p, 64),
    "auto_device_or_host": lambda p: SEL.auto_device_or_host(),
    "measure_device_feed_gbps": lambda p: SEL.measure_device_feed_gbps(),
    "sharded_sort_records": lambda p: MS.sharded_sort_records(records_of(p)),
    "sort_file_mesh": lambda p: MS.sort_file_mesh(p, p + ".mesh"),
    "multihost_sort_file mesh": lambda p: MH.multihost_sort_file(p, p + ".pod", engine="mesh"),
    "multihost_sort_file auto": lambda p: MH.multihost_sort_file(p, p + ".pod"),
    "multihost_file_stats": lambda p: MH.multihost_file_stats(p),
    "multihost_barcode_histogram": lambda p: MH.multihost_barcode_histogram(p),
    "multihost_map_reduce": lambda p: MH.multihost_map_reduce(p, D.STATS_MAP_REDUCE),
    "multihost_placed_batches": lambda p: MH.multihost_placed_batches(MmapReader(p)),
    "exchange_backend": lambda p: MH.exchange_backend(),
    "multihost_correct_file": lambda p: MH.multihost_correct_file(p, p + ".mhfixed", [7, 14]),
    "multihost_export_fastq": lambda p: MH.multihost_export_fastq(p, p + ".mh.fastq"),
    "multihost_ingest_fastq": lambda p: MH.multihost_ingest_fastq(fastq_of(p), p + ".mhback", 16,
                                                                  12),
    "multihost_dedup_file unsorted": lambda p: without_native(MH.multihost_dedup_file, p,
                                                              p + ".mhdedup"),
    "RecordLoader.epoch": lambda p: RecordLoader(p, 8).epoch(0),
}


def without_native(fn, *args):
    """``fn(*args)`` where the host library is not built, so that an unsorted
    input is sorted on the device, as where ``g++`` is missing."""
    with mock.patch.object(native, "available", lambda: False):
        return fn(*args)


def fastq_of(path):
    """A FASTQ of ``path``'s records, written beside it by the host engine."""
    records = records_of(path)
    bc, umi, idx = PL.decode_batch(records, 16, 12, engine="host")
    with open(path + ".fastq", "wb") as f:
        f.write(PL._fastq_block(bc, umi, idx, ord("I")))
    return path + ".fastq"


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_points_without_device_raise(ibu_file, name):
    with pytest.raises(NoCardError, match='device="cpu"'):
        ENTRY_POINTS[name](ibu_file)


#: the entry points above that write a file
WRITERS = ("encode_sorted_file", "sort_file_device", "dedup_file unsorted", "count_matrix device",
           "call_cells device", "correct_file", "export_fastq", "ingest_fastq", "sort_file_mesh",
           "multihost_sort_file mesh", "multihost_sort_file auto", "multihost_correct_file",
           "multihost_export_fastq", "multihost_ingest_fastq", "multihost_dedup_file unsorted")


@pytest.mark.parametrize("name", WRITERS)
def test_entry_points_without_a_card_write_nothing(ibu_file, name):
    """Without a card a call that writes a file raises before it creates its
    output, and leaves no temporary file beside it."""
    if name in ("ingest_fastq", "multihost_ingest_fastq"):
        fastq_of(ibu_file)  # its input
    before = sorted(os.listdir(os.path.dirname(ibu_file)))
    with pytest.raises(NoCardError):
        ENTRY_POINTS[name](ibu_file)
    assert sorted(os.listdir(os.path.dirname(ibu_file))) == before


def test_the_same_calls_run_on_the_cpu_by_name(ibu_file):
    records = np.asarray(MmapReader(ibu_file).records)
    bc, umi, idx = PL.decode_batch(records, 16, 12, device="cpu")
    assert PL.encode_batch(bc, umi, idx, device="cpu").tobytes() == records.tobytes()
    assert PL.file_stats(ibu_file, device="cpu")["count"] == 64
    assert D.stream_file_histogram(MmapReader(ibu_file), device="cpu") == {
        int(b): 1 for b in records["barcode"]}


def test_the_workflow_calls_run_on_the_cpu_by_name(ibu_file):
    p = ibu_file
    PL.sort_file_device(p, p + ".sorted", device="cpu")
    assert MmapReader(p + ".sorted").header().sorted()
    assert PL.dedup_file(p, p + ".dedup", device="cpu")["molecules"] == 64
    assert PL.count_matrix(p + ".sorted", p + ".m", engine="device", device="cpu")["entries"] == 64
    assert PL.call_cells(p, p + ".txt", engine="device", device="cpu")["barcodes"] == 64
    assert PL.correct_file(p, p + ".fixed", [7, 14], device="cpu")["exact"] == 2
    fixed, status = TC.correct_batch(records_of(p)["barcode"], np.array([7], np.uint64), 16,
                                     device="cpu")
    assert status.tolist().count(TC.EXACT) == 1
    assert int(TK.torch_knee_index(np.array([9, 5, 1]), device="cpu")) == 3
    # the host engines need no device
    assert PL.count_matrix(p, p + ".h")["entries"] == 64
    assert PL.call_cells(p, p + ".h.txt")["barcodes"] == 64
    assert PL.dedup_file(p + ".sorted", p + ".dd")["molecules"] == 64


def test_the_fastq_calls_run_on_the_cpu_by_name(ibu_file):
    p = ibu_file
    PL.sort_file_device(p, p + ".sorted", device="cpu")
    assert PL.export_fastq(p + ".sorted", p + ".fastq", device="cpu") == 64
    assert PL.ingest_fastq(p + ".fastq", p + ".back", 16, 12, device="cpu") == 64
    back, want = records_of(p + ".back"), records_of(p + ".sorted")
    assert np.array_equal(back["barcode"], want["barcode"]) and MmapReader(p + ".back").header().sorted()
    assert SEL.auto_codec_engine(device="cpu") in ("host", "device")
    assert SEL.auto_device_or_host(device="cpu") == "host"
    assert SEL.auto_stats_engine(p, 64, device="cpu") in ("device", "native", "host")
    # the file tools are host code and need no device
    assert PL.check_file(p)["ok"] and PL.filter_file(p, p + ".kept", [7, 14])["kept"] == 2
    assert len(PL.lookup_barcodes(p + ".sorted", [7])) == 1
    assert PL.subsample_file(p, p + ".sub", n=5)["sampled"] == 5
    assert PL.repair_file(p, p + ".fixed")["records"] == 64
    assert PL.concat_files(PL.split_file(p, p + ".{}.part", 3), p + ".cat")["records"] == 64


def test_the_cohort_calls_run_on_the_cpu_by_name(ibu_file):
    """Outside a cohort (a world of one) the cohort layer's entry points run
    on the CPU when asked; the host sort engine needs no device."""
    p = ibu_file
    records = records_of(p)
    want = np.sort(records, order=("barcode", "umi", "index"))
    assert np.array_equal(MS.sharded_sort_records(records, device="cpu"), want)
    MS.sort_file_mesh(p, p + ".mesh", device="cpu")
    MH.multihost_sort_file(p, p + ".auto", device="cpu")
    MH.multihost_sort_file(p, p + ".host", engine="host")
    for out in (".mesh", ".auto", ".host"):
        assert np.array_equal(records_of(p + out), want)
    assert MH.multihost_file_stats(p, device="cpu")["count"] == 64
    assert MH.multihost_barcode_histogram(p, device="cpu") == {int(b): 1 for b in records["barcode"]}
    assert MH.exchange_backend("cpu") is None
    assert sum(len(b) for b in RecordLoader(p, 8, device="cpu").epoch(0)) == 64
    assert MH.multihost_correct_file(p, p + ".fixed", [7, 14], device="cpu")["exact"] == 2
    assert MH.multihost_export_fastq(p + ".mesh", p + ".fastq", device="cpu") == (
        64, 64, p + ".fastq")
    assert MH.multihost_ingest_fastq(p + ".fastq", p + ".back", 16, 12, device="cpu") == 64
    assert np.array_equal(records_of(p + ".back")["barcode"], want["barcode"])
    # the host engines need no device: filter, count, a sorted dedup, and an
    # unsorted one where the native sort runs
    assert MH.multihost_filter_file(p, p + ".kept", [7, 14])["kept"] == 2
    assert MH.multihost_count_matrix(p + ".mesh", p + ".m")["entries"] == 64
    assert MH.multihost_dedup_file(p + ".mesh", p + ".dd")["molecules"] == 64
    assert MH.multihost_dedup_file(p, p + ".du")["molecules"] == 64


@pytest.mark.parametrize("argv", [
    ["sort", "{p}", "out", "--engine", "mesh"],
    ["sort", "{p}", "out", "--engine", "pod"],
    ["stats", "{p}", "--distributed"],
    ["histogram", "{p}", "--distributed"],
    ["correct", "{p}", "out", "--barcodes", "{allow}", "--distributed"],
    ["export-fastq", "{sorted}", "out", "--distributed"],
    ["ingest-fastq", "{fastq}", "out", "--distributed"],
], ids=lambda v: " ".join(v[2:]).replace("{p} ", ""))
def test_cli_cohort_commands_without_a_card_exit_2(cli_inputs, monkeypatch, capsys, argv):
    """The cohort forms of the commands (in a world of one here) need a card
    like the rest: one line and exit 2 without one, and ``--device cpu``
    runs."""
    from ibu_tpu_torch.__main__ import main

    inputs, out = cli_inputs
    monkeypatch.chdir(out)
    argv = [a.format(**inputs) for a in argv]
    assert main(argv) == 2
    printed = capsys.readouterr()
    assert (printed.out, printed.err) == ("", f"ibu_tpu_torch {argv[0]}: {NO_CARD_HINT}\n")
    assert not list(out.iterdir())
    assert main(argv + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out or list(out.iterdir())


@pytest.mark.parametrize("env", ["host", "device"])
def test_the_override_decides_before_the_device_is_looked_up(ibu_file, monkeypatch, env):
    """``IBU_AUTO_ENGINE`` decides first, as in the JAX package: the host
    engine then needs no card, and the device engine still raises."""
    monkeypatch.setenv("IBU_AUTO_ENGINE", env)
    if env == "host":
        assert PL.export_fastq(ibu_file, ibu_file + ".fastq") == 64
        assert PL.file_stats(ibu_file)["engine"] == "host"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            PL.export_fastq(ibu_file, ibu_file + ".fastq")
        with pytest.raises(RuntimeError, match='device="cpu"'):
            PL.file_stats(ibu_file)


@pytest.mark.parametrize("name,module,argv", [
    ("fastq_ingest", FI, ["--reads", "100"]), ("roundtrip", RT, ["--records", "0.001"])])
def test_the_examples_without_a_card_exit_2(tmp_path, capsys, monkeypatch, name, module, argv):
    monkeypatch.chdir(tmp_path)
    assert module.main(argv) == 2
    printed = capsys.readouterr().out
    assert f"{name}: no CUDA card" in printed and "--device cpu" in printed
    assert module.main([*argv, "--device", "cuda"]) == 2
    assert not list(tmp_path.iterdir())
    assert module.main([*argv, "--device", "cpu"]) == 0
    assert "cleaned up" in capsys.readouterr().out and not list(tmp_path.iterdir())


@pytest.mark.parametrize("name,argv", [
    ("random", ["r.ibu", "--records", "0.001"]),
    ("parallel", ["--records", "0.001", "--engine", "both"])])
def test_random_and_parallel_examples_without_a_card_exit_2(tmp_path, capsys, monkeypatch, name,
                                                            argv):
    from ibu_tpu_torch.examples import parallel, random

    main = {"random": random.main, "parallel": parallel.main}[name]
    monkeypatch.chdir(tmp_path)
    for extra in ([], ["--device", "cuda"]):
        assert main([*argv, *extra]) == 2
        printed = capsys.readouterr().out
        assert f"{name}: " in printed and "no CUDA card" in printed
        assert not list(tmp_path.iterdir())
    assert main([*argv, "--device", "cpu"]) == 0
    # the host engine of the parallel example needs no device
    assert parallel.main(["--records", "0.001", "--engine", "host"]) == 0


def test_workflow_without_a_card_exits_2(tmp_path, capsys):
    assert W.main(["--reads", "100", "--workdir", str(tmp_path)]) == 2
    printed = capsys.readouterr().out
    assert "workflow: no CUDA card" in printed and "--device cpu" in printed
    assert W.main(["--reads", "100", "--device", "cuda", "--workdir", str(tmp_path)]) == 2
    assert not list(tmp_path.iterdir())


#: one call of each command that takes ``--device``, with an engine that
#: runs on the device
CLI_DEVICE_ARGV = {
    "stats": ["stats", "{p}", "--engine", "device"],
    "sort": ["sort", "{p}", "out", "--engine", "device"],
    "histogram": ["histogram", "{p}", "--engine", "device"],
    "decode": ["decode", "{p}"],
    "cells": ["cells", "{p}", "-o", "out", "--engine", "device"],
    "count": ["count", "{sorted}", "out", "--engine", "device"],
    "correct": ["correct", "{p}", "out", "--barcodes", "{allow}"],
    "dedup": ["dedup", "{p}", "out", "--assume-sorted", "no"],
    "ingest-fastq": ["ingest-fastq", "{fastq}", "out"],
    "export-fastq": ["export-fastq", "{sorted}", "out"],
}


@pytest.fixture
def cli_inputs(ibu_file, tmp_path):
    p = ibu_file
    native.sort_file(p, p + ".sorted")
    with open(p + ".allow", "w") as f:
        f.write("7\n14\n")
    out = tmp_path / "out_dir"
    out.mkdir()
    return {"p": p, "sorted": p + ".sorted", "allow": p + ".allow", "fastq": fastq_of(p)}, out


@pytest.mark.parametrize("command", list(CLI_DEVICE_ARGV))
def test_cli_device_commands_without_a_card_exit_2(cli_inputs, monkeypatch, capsys, command):
    """No card and no ``--device``: one line on stderr naming ``--device
    cpu``, exit 2, nothing on stdout and no output file; ``--device cuda``
    the same; ``--device cpu`` runs."""
    from ibu_tpu_torch.__main__ import main

    inputs, out = cli_inputs
    monkeypatch.chdir(out)
    if command == "dedup":  # the pre-sort then runs on the device
        monkeypatch.setattr(native, "available", lambda: False)
    argv = [a.format(**inputs) for a in CLI_DEVICE_ARGV[command]]
    for extra in ([], ["--device", "cuda"]):
        assert main(argv + extra) == 2
        printed = capsys.readouterr()
        assert printed.out == ""
        assert printed.err == f"ibu_tpu_torch {command}: {NO_CARD_HINT}\n"
        assert "--device cpu" in printed.err
        assert not list(out.iterdir())
    assert main(argv + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out or list(out.iterdir())


@pytest.mark.parametrize("argv,env", [
    (["stats", "{p}", "--engine", "native"], None),
    (["stats", "{p}", "--engine", "host"], None),
    (["stats", "{p}"], "host"),
    (["histogram", "{p}", "--engine", "host"], None),
    (["sort", "{p}", "out"], None),
    (["dedup", "{p}", "out", "--assume-sorted", "no"], None),
    (["count", "{sorted}", "out"], None),
    (["cells", "{p}", "-o", "out"], None),
    (["decode", "{p}"], "host"),
    (["export-fastq", "{sorted}", "out"], "host"),
    (["ingest-fastq", "{fastq}", "out"], "host"),
    (["sort", "{p}", "out", "--engine", "pod"], "pod host"),
    (["filter", "{p}", "out", "--barcodes", "{allow}", "--distributed"], None),
    (["count", "{sorted}", "out", "--distributed"], None),
    (["dedup", "{sorted}", "out", "--distributed"], None),
    (["dedup", "{p}", "out", "--distributed", "--assume-sorted", "no"], None),
], ids=lambda v: v if isinstance(v, str) else " ".join(v) if v else "")
def test_cli_host_engines_need_no_card(cli_inputs, monkeypatch, capsys, argv, env):
    """A command whose engine does not use a device looks none up: it runs
    without a card and without ``--device``."""
    from ibu_tpu_torch.__main__ import main

    inputs, out = cli_inputs
    monkeypatch.chdir(out)
    if env == "pod host":
        monkeypatch.setenv("IBU_POD_SORT_ENGINE", "host")
    elif env:
        monkeypatch.setenv("IBU_AUTO_ENGINE", env)
    assert main([a.format(**inputs) for a in argv]) == 0
    assert "no CUDA card" not in capsys.readouterr().err
