"""The reference crate's public API in the port, against ``ibu_tpu`` on the
same bytes: the flat ``__all__``, the reader and writer constructors and
``clone``, ``ingest``, the large-batch direct write, the host thread engine,
``into_ibu_error``, the host ``sort_records``, ``reopen_decompressed_at``,
the native bulk I/O, and the two examples' printed lines. Exact, on records
made from a numpy seed."""

import ast
import gzip
import io
import json
import os
import re
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

import ibu_tpu
import ibu_tpu_torch
from ibu_tpu import native as JN
from ibu_tpu.io import compression as JCOMP
from ibu_tpu_torch import native as TN
from ibu_tpu_torch.examples import parallel as TPAR
from ibu_tpu_torch.examples import random as TRAND
from ibu_tpu_torch.io import compression as TCOMP
from tests.test_torch_fastq import run_reference, untimed

PKGS = {"jax": ibu_tpu, "torch": ibu_tpu_torch}


def recs(pkg, n, seed=0):
    rng = np.random.default_rng(seed)
    out = np.empty(n, dtype=pkg.RECORD_DTYPE)
    for f in ("barcode", "umi", "index"):
        out[f] = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    return out


def write(pkg, path, records, sorted_flag=False):
    h = pkg.Header.new(16, 12)
    if sorted_flag:
        h.set_sorted()
    with pkg.Writer.from_path(str(path), h) as w:
        w.write_batch(records)
    return str(path)


def outcome(fn, *args, **kwargs):
    """``("ok", value)`` or ``("error", class name, text)``."""
    try:
        return ("ok", fn(*args, **kwargs))
    except Exception as e:  # noqa: BLE001 (the error is the result compared)
        return ("error", type(e).__name__, str(e))


def test_all_equals_the_reference():
    assert set(ibu_tpu_torch.__all__) == set(ibu_tpu.__all__)
    assert len(ibu_tpu_torch.__all__) == 33
    for name in ibu_tpu_torch.__all__:
        assert getattr(ibu_tpu_torch, name) is not None
    assert ibu_tpu_torch.BATCH_SIZE == ibu_tpu.BATCH_SIZE
    assert ibu_tpu_torch.DEFAULT_BUFFER_SIZE == ibu_tpu.DEFAULT_BUFFER_SIZE
    assert ibu_tpu_torch.DEFAULT_BUFFER_RECORDS == ibu_tpu.DEFAULT_BUFFER_RECORDS
    assert (ibu_tpu_torch.MAGIC, ibu_tpu_torch.VERSION, ibu_tpu_torch.HEADER_SIZE) == \
        (ibu_tpu.MAGIC, ibu_tpu.VERSION, ibu_tpu.HEADER_SIZE)


#: the reference's public methods (dunders included) that the port's class of
#: the same module and name lacks, each with its reason
METHODS_ABSENT = {
    ("parallel/device.py", "MapReduce"): {
        # a jitted step and states placed over a JAX mesh: here each rank
        # folds on its own card and MapReduce.finalize merges the ranks
        "compile_step", "initial_states",
    },
}


def _class_methods(root: Path) -> dict:
    """``(module path, class name)`` → the names of the methods its body
    defines, for every top-level class under ``root`` (the reference's
    ``native/`` package is the port's ``native.py``)."""
    out = {}
    for path in sorted(root.rglob("*.py")):
        rel = str(path.relative_to(root))
        rel = "native.py" if rel.startswith("native/") else rel
        for node in ast.parse(path.read_text(), str(path)).body:
            if isinstance(node, ast.ClassDef):
                out[(rel, node.name)] = {
                    n.name for n in node.body
                    if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    return out


def test_every_class_has_the_references_public_methods():
    """An AST scan of both packages: every class of the reference has its
    counterpart in the port's module of the same path, and every public or
    dunder method of it is there too, except those listed above."""
    repo = Path(__file__).resolve().parents[1]
    ref, port = _class_methods(repo / "ibu_tpu"), _class_methods(repo / "ibu_tpu_torch")
    assert len(ref) >= 26 and ("constructs/record.py", "Record") in ref
    assert sorted(set(ref) - set(port)) == []
    missing = {key: {m for m in methods - port[key] if not m.startswith("_") or m.endswith("__")}
               for key, methods in ref.items()}
    assert {key: m for key, m in missing.items() if m} == METHODS_ABSENT


U64_MAX = (1 << 64) - 1


@pytest.mark.parametrize("fields", [(U64_MAX, 1, 1 << 63), (U64_MAX,) * 3, (0, 0, 0),
                                    (0x1234, 0x5678, 42), "seeded"])
def test_record_dict_round_trips_through_json_as_the_reference(fields):
    rng = np.random.default_rng(12)
    triples = ([tuple(int(v) for v in rng.integers(0, 1 << 64, 3, dtype=np.uint64))
                for _ in range(50)] if fields == "seeded" else [fields])
    for barcode, umi, index in triples:
        r = ibu_tpu_torch.Record(barcode, umi, index)
        d = r.to_dict()
        assert d == ibu_tpu.Record(barcode, umi, index).to_dict()
        assert d == {"barcode": barcode, "umi": umi, "index": index}
        back = ibu_tpu_torch.Record.from_dict(json.loads(json.dumps(d)))
        assert back == r and back.as_bytes() == r.as_bytes()
        assert ibu_tpu.Record.from_dict(d).as_bytes() == back.as_bytes()


# -- Reader -------------------------------------------------------------------


def source(kind, path, data):
    """The same file bytes as a path (plain or gzip) or an in-memory buffer."""
    if kind == "gzip":
        Path(path).write_bytes(gzip.compress(data))
        return path
    Path(path).write_bytes(data)
    return path


@pytest.mark.parametrize("kind", ["plain", "gzip", "bytesio"])
@pytest.mark.parametrize("taken", [0, 1, 49152, 50_000])
def test_reader_clone_mid_stream_matches_jax(tmp_path, kind, taken):
    """Read ``taken`` records one at a time (crossing a refill at 49152),
    clone, then read the rest from both: the clone and the original each
    give the same remainder, in both packages."""
    data = (ibu_tpu.Header.new(16, 12).as_bytes()
            + recs(ibu_tpu, 60_000, seed=1).tobytes())
    path = source(kind, str(tmp_path / "c.ibu"), data)
    rests = {}
    for name, pkg in PKGS.items():
        r = pkg.Reader(io.BytesIO(data)) if kind == "bytesio" else pkg.Reader.from_path(path)
        head = [next(r).as_bytes() for _ in range(taken)]
        c = r.clone()
        assert c.bytes_read == r.bytes_read
        tail_c = b"".join(b.tobytes() for b in c.batches())
        tail_r = b"".join(b.tobytes() for b in r.batches())
        assert tail_c == tail_r
        rests[name] = (b"".join(head), tail_r)
        r.close()
        c.close()
    assert rests["torch"] == rests["jax"]
    assert b"".join(rests["torch"]) == data[32:]


def test_reader_clone_refusals_match_jax(tmp_path, monkeypatch):
    data = ibu_tpu.Header.new(16, 12).as_bytes() + recs(ibu_tpu, 3).tobytes()
    got = {}
    for name, pkg in PKGS.items():
        monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(gzip.compress(data))))
        gz = outcome(pkg.Reader.from_stdin().clone)
        monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(data)))
        plain = outcome(pkg.Reader.from_stdin().clone)
        got[name] = (gz, plain)
    assert got["torch"] == got["jax"]
    assert got["torch"][0][:2] == ("error", "TypeError")


@pytest.mark.parametrize("compress", [False, True])
def test_from_stdin_and_optional_path_match_jax(tmp_path, monkeypatch, compress):
    data = ibu_tpu.Header.new(16, 12).as_bytes() + recs(ibu_tpu, 1000, seed=2).tobytes()
    path = str(tmp_path / "s.ibu")
    Path(path).write_bytes(data)
    stdin = gzip.compress(data) if compress else data
    got = {}
    for name, pkg in PKGS.items():
        out = []
        for make in (pkg.Reader.from_stdin, lambda pkg=pkg: pkg.Reader.from_optional_path(None)):
            monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(stdin)))
            r = make()
            out.append((r.header().as_bytes(), b"".join(b.tobytes() for b in r.batches())))
        r = pkg.Reader.from_optional_path(path)
        out.append((r.header().as_bytes(), b"".join(b.tobytes() for b in r.batches())))
        r.close()
        got[name] = out
    assert got["torch"] == got["jax"]
    assert all(h + body == data for h, body in got["torch"])


@pytest.mark.parametrize("n", [0, 1000, 350_000])
def test_load_to_vec_matches_jax(tmp_path, n, monkeypatch):
    """From 8 MB (350,000 records) the native threaded pread reads the file;
    below it, and without the host library, numpy does."""
    path = write(ibu_tpu, tmp_path / "l.ibu", recs(ibu_tpu, n, seed=3))
    jh, jr = ibu_tpu.load_to_vec(path)
    th, tr = ibu_tpu_torch.load_to_vec(path)
    assert th.as_bytes() == jh.as_bytes() and tr.tobytes() == jr.tobytes()
    monkeypatch.setattr(TN, "available", lambda: False)
    assert ibu_tpu_torch.load_to_vec(path)[1].tobytes() == jr.tobytes()


def test_reopen_decompressed_at_matches_jax(tmp_path):
    data = bytes(range(256)) * 4000
    path = str(tmp_path / "z.gz")
    Path(path).write_bytes(gzip.compress(data))
    for pos in (0, 1, 300_000, len(data)):
        with JCOMP.reopen_decompressed_at(path, pos) as j, \
                TCOMP.reopen_decompressed_at(path, pos) as t:
            assert t.read() == j.read() == data[pos:]
    j = outcome(JCOMP.reopen_decompressed_at, path, len(data) + 5)
    t = outcome(TCOMP.reopen_decompressed_at, path, len(data) + 5)
    assert t == j and t[1] == "CompressionError"


# -- Writer -------------------------------------------------------------------


def test_writer_in_memory_iter_and_into_inner_match_jax():
    rows = recs(ibu_tpu, 5, seed=4)
    got = {}
    for name, pkg in PKGS.items():
        w = pkg.Writer.in_memory(pkg.Header.new(16, 12))
        w.write_iter(pkg.Record(int(r["barcode"]), int(r["umi"]), int(r["index"])) for r in rows)
        w.finish()
        inner = w.into_inner()
        headless = pkg.Writer.in_memory()
        headless.write_batch(rows)
        headless.finish()
        got[name] = (inner.getvalue(), w.records_written, headless.inner.getvalue())
    assert got["torch"] == got["jax"]
    assert got["torch"][0][32:] == rows.tobytes() == got["torch"][2]


def test_writer_ingest_matches_jax():
    got = {}
    for name, pkg in PKGS.items():
        w = pkg.Writer.in_memory(pkg.Header.new(16, 12))
        shards = [pkg.Writer.new_headless(io.BytesIO()), pkg.Writer.in_memory()]
        for k, s in enumerate(shards):
            s.write_batch(recs(pkg, 100 + k, seed=5 + k))
            w.ingest(s)
        w.finish()
        errors = (outcome(w.ingest, pkg.Writer.in_memory(pkg.Header.new(16, 12))),
                  outcome(w.ingest, pkg.Writer(open(os.devnull, "wb"), None)))
        got[name] = (w.inner.getvalue(), w.records_written,
                     [s.inner.getvalue() for s in shards], errors)
    assert got["torch"] == got["jax"]
    assert got["torch"][1] == 201 and got["torch"][2] == [b"", b""]
    assert [e[1] for e in got["torch"][3]] == ["ValueError", "TypeError"]


def test_writer_from_stdout_and_optional_path_match_jax(tmp_path, monkeypatch):
    rows = recs(ibu_tpu, 70, seed=7)
    got = {}
    for name, pkg in PKGS.items():
        out = []
        for make in (pkg.Writer.from_stdout,
                     lambda h, pkg=pkg: pkg.Writer.from_optional_path(None, h)):
            sink = io.BytesIO()
            monkeypatch.setattr(sys, "stdout", io.TextIOWrapper(sink))
            w = make(pkg.Header.new(16, 12))
            w.write_batch(rows)
            w.close()  # stdout stays open
            out.append(sink.getvalue())
        path = tmp_path / f"{name}.ibu.gz"
        with pkg.Writer.from_optional_path(str(path), pkg.Header.new(16, 12), "auto") as w:
            w.write_batch(rows)
        out.append(gzip.decompress(path.read_bytes()))
        got[name] = out
    monkeypatch.undo()
    assert got["torch"] == got["jax"]
    assert got["torch"][0][32:] == rows.tobytes()


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("n", [60_000, 400_000])
def test_direct_path_batches_match_jax(tmp_path, monkeypatch, native, n):
    """A batch over the 1,179,648-byte buffer goes straight to the sink, from
    8 MB (400,000 records) through the native pwrite; small batches around
    it stay buffered."""
    if not native:
        monkeypatch.setattr(TN, "available", lambda: False)
    for name, pkg in PKGS.items():
        with pkg.Writer.from_path(str(tmp_path / f"{name}.ibu"), pkg.Header.new(16, 12)) as w:
            w.write_batch(recs(pkg, 10, seed=8))
            w.write_batch(recs(pkg, n, seed=9))
            w.write_batch(recs(pkg, 10, seed=10))
            assert w.records_written == n + 20
    assert (tmp_path / "torch.ibu").read_bytes() == (tmp_path / "jax.ibu").read_bytes()


# -- the host thread engine -----------------------------------------------------


def summing_processor(pkg, per_record: bool):
    """A processor adding the three fields into a shared total under a lock."""
    totals, lock = [0, 0, 0], threading.Lock()
    base = pkg.ParallelProcessor if per_record else pkg.BatchProcessor

    class Sums(base):
        def __init__(self):
            self.local = [0, 0, 0]
            self.tids = set()

        def process_record(self, record):
            for k, v in enumerate((record.barcode, record.umi, record.index)):
                self.local[k] += v

        def process_batch(self, records):
            for k, f in enumerate(("barcode", "umi", "index")):
                self.local[k] += int(records[f].sum(dtype=object))

        def on_batch_complete(self):
            with lock:
                for k in range(3):
                    totals[k] += self.local[k]
            self.local = [0, 0, 0]

    if per_record:
        del Sums.process_batch
    else:
        del Sums.process_record
    return Sums(), totals


@pytest.mark.parametrize("threads", [1, 2, 4])
@pytest.mark.parametrize("per_record", [False, True])
def test_process_parallel_sums_match_jax(tmp_path, threads, per_record):
    n = 3001 if per_record else 50_001
    rows = recs(ibu_tpu, n, seed=11)
    path = write(ibu_tpu, tmp_path / "p.ibu", rows)
    want = [int(rows[f].sum(dtype=object)) for f in ("barcode", "umi", "index")]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads often: a lost update would show
    try:
        for pkg in PKGS.values():
            proc, totals = summing_processor(pkg, per_record)
            pkg.process_parallel(pkg.MmapReader(path), proc, threads, batch_size=997)
            assert totals == want
            proc, totals = summing_processor(pkg, per_record)
            pkg.MmapReader(path).clone().process_parallel(proc, threads)
            assert totals == want
    finally:
        sys.setswitchinterval(switch)


def test_process_parallel_errors_match_jax(tmp_path):
    path = write(ibu_tpu, tmp_path / "e.ibu", recs(ibu_tpu, 100, seed=12))
    got = {}
    for name, pkg in PKGS.items():
        class Fails(pkg.BatchProcessor):
            def __init__(self, err):
                self.err = err

            def process_batch(self, records):
                raise self.err

            def clone(self):
                return Fails(self.err)

        got[name] = [outcome(pkg.process_parallel, pkg.MmapReader(path), Fails(err), 2)
                     for err in (ZeroDivisionError("boom"), pkg.InvalidMapSize())]
    assert got["torch"] == got["jax"]
    assert got["torch"][0][:2] == ("error", "ProcessError")


def test_into_ibu_error_and_sort_records_match_jax():
    for pkg in PKGS.values():
        inner = pkg.InvalidIndex(idx=3, max=2)
        assert pkg.into_ibu_error(inner) is inner
    j = ibu_tpu.into_ibu_error(KeyError("k"))
    t = ibu_tpu_torch.into_ibu_error(KeyError("k"))
    assert type(t).__name__ == type(j).__name__ == "ProcessError" and str(t) == str(j)
    rng = np.random.default_rng(13)
    rows = recs(ibu_tpu, 5000, seed=14)
    rows["barcode"] = rng.integers(0, 7, 5000, dtype=np.uint64)  # ties on the first key
    rows["umi"] = rng.integers(0, 3, 5000, dtype=np.uint64)
    assert ibu_tpu_torch.sort_records(rows).tobytes() == ibu_tpu.sort_records(rows).tobytes()


# -- the native bulk I/O ------------------------------------------------------------


def test_native_bulk_io_matches_jax(tmp_path):
    rows = recs(ibu_tpu, 300_000, seed=15)
    header = ibu_tpu.Header.new(16, 12).as_bytes()
    for name, mod in (("jax", JN), ("torch", TN)):
        mod.write_file(str(tmp_path / f"{name}.ibu"), header, rows)
        mod.write_file(str(tmp_path / f"{name}.run"), None, rows[:10])
    for suffix in (".ibu", ".run"):
        assert (tmp_path / f"torch{suffix}").read_bytes() == (tmp_path / f"jax{suffix}").read_bytes()
    path = str(tmp_path / "jax.ibu")
    assert TN.file_size(path) == JN.file_size(path) == 32 + 24 * len(rows)
    assert TN.read_records(path, 1000, 32 + 24 * 5).tobytes() == \
        JN.read_records(path, 1000, 32 + 24 * 5).tobytes() == rows[5:1005].tobytes()
    for threads in (0, 1, 3):
        got = np.empty(len(rows), dtype=ibu_tpu.RECORD_DTYPE)
        with open(path, "rb") as f:
            TN.pread_parallel(f.fileno(), got, 32, nthreads=threads)
            assert f.tell() == 0  # the fd's offset is untouched
        assert got.tobytes() == rows.tobytes()
        for name, mod in (("jax", JN), ("torch", TN)):
            with open(tmp_path / f"{name}.pw", "wb") as f:
                mod.pwrite_parallel(f.fileno(), header, 0, nthreads=threads)
                mod.pwrite_parallel(f.fileno(), rows.view(np.uint8), 32, nthreads=threads)
        assert (tmp_path / "torch.pw").read_bytes() == (tmp_path / "jax.pw").read_bytes() \
            == Path(path).read_bytes()
    assert outcome(TN.file_size, str(tmp_path / "nope")) == outcome(JN.file_size, str(tmp_path / "nope"))
    with pytest.raises(ValueError, match="header must be 32 bytes"):
        TN.write_file(str(tmp_path / "x"), b"short", rows)


# -- the examples -------------------------------------------------------------------


def test_random_example_prints_the_reference_lines(tmp_path, capsys):
    path = str(tmp_path / "r.ibu")
    argv = [path, "--records", "0.02", "--barcodes", "7", "--max-index", "11", "--seed", "5"]
    assert TRAND.main([*argv, "--device", "cpu"]) == 0
    got = capsys.readouterr().err.splitlines()
    first = Path(path).read_bytes()
    assert TRAND.main([*argv, "--device", "cpu"]) == 0  # the seed fixes the file
    assert Path(path).read_bytes() == first
    import subprocess

    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(Path(__file__).parents[1])}
    want = subprocess.run([sys.executable, str(Path(__file__).parents[1] / "examples" / "random.py"),
                           str(tmp_path / "j.ibu"), *argv[1:]], capture_output=True, text=True,
                          env=env, timeout=120).stderr.splitlines()

    def shape(lines):
        return [re.sub(r"[\d.]+(s|\b)", "_", line) for line in lines]

    assert got[0] == want[0] == "Finished generating 20000 records"
    assert shape(got) == shape(want) == ["Finished generating _ records", "Elapsed time: _",
                                         "Bandwidth: _ Gb/s"]
    h, rows = ibu_tpu_torch.load_to_vec(path)
    assert (h.bc_len, h.umi_len, len(rows)) == (16, 12, 20_000)
    assert rows["barcode"].max() < 7 and rows["index"].max() < 11
    assert len(np.unique(rows["umi"])) == 20_000 and (rows["umi"] >> np.uint64(63)).any()


def test_parallel_example_prints_the_reference_lines(tmp_path, capsys):
    argv = ["--records", "0.3", "--engine", "both", "--threads", "3", "--keep"]
    assert TPAR.main([*argv, "--file", str(tmp_path / "t.ibu"), "--device", "cpu"]) == 0
    def rateless(text):
        return [re.sub(r"[\d.]+ M rec/s", "_", line) for line in untimed(text)]

    got = rateless(capsys.readouterr().out)
    want = rateless(run_reference("parallel.py", *argv, "--file", str(tmp_path / "j.ibu"),
                                  cwd=tmp_path))
    assert got == want and sum("checksum OK" in line for line in got) == 2
    assert (tmp_path / "t.ibu").read_bytes() == (tmp_path / "j.ibu").read_bytes()
    assert TPAR.main(["--records", "0.001", "--engine", "host", "--file", str(tmp_path / "h.ibu")]) == 0
    assert "cleaned up" in capsys.readouterr().out and not (tmp_path / "h.ibu").exists()
