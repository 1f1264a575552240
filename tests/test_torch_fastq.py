"""FASTQ export and ingest, the TSV text and the two examples of
``ibu_tpu_torch`` against ``ibu_tpu`` on the CPU, on the same seeded inputs.

Tolerance: none. Output files are compared byte for byte (``.gz`` and ``.zst``
after decompression: the compressed bytes carry a time stamp), arrays and
counts for equality, and a raised error by its class name and its text,
character for character. The port runs with ``device="cpu"``, the JAX package
on its CPU backend. ``fastq_prefix_batches`` runs with the native parser and
with the numpy parser, and ``ingest_fastq`` with and without the native
library, in both packages.
"""

import gzip
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from ibu_tpu import Header, Writer
from ibu_tpu import native as JN
from ibu_tpu import pipelines as JPL
from ibu_tpu.constructs.record import make_records
from ibu_tpu.parallel import select as JSEL
from ibu_tpu_torch import native as TN
from ibu_tpu_torch import pipelines as TPL
from ibu_tpu_torch.examples import fastq_ingest as TFI
from ibu_tpu_torch.examples import roundtrip as TRT
from ibu_tpu_torch.parallel import select as TSEL
from tests.test_torch_filetools import outcome, same, same_files

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def rows(n, length, seed):
    return ACGT[np.random.default_rng(seed).integers(0, 4, (n, length))]


@pytest.fixture(autouse=True)
def fresh_memo(monkeypatch):
    """Each test decides its engine anew, in both packages."""
    monkeypatch.delenv("IBU_AUTO_ENGINE", raising=False)
    JSEL.reset_probe_memo()
    TSEL.reset_probe_memo()
    yield
    JSEL.reset_probe_memo()
    TSEL.reset_probe_memo()


@pytest.fixture(params=["native", "numpy"])
def parser(request, monkeypatch):
    """Run a test with the native library, then without it, in both
    packages (the numpy parser, the numpy codec and the in-memory sort)."""
    if request.param == "numpy":
        monkeypatch.setattr(JN, "available", lambda: False)
        monkeypatch.setattr(TN, "available", lambda: False)
    elif not (JN.available() and TN.available()):
        pytest.skip("native runtime unavailable")
    return request.param


def ibu_file(tmp_path, n=500, bc_len=16, umi_len=12, name="x.ibu", index=None,
             sort=False, compression=None):
    bc, umi = rows(n, bc_len, 3), rows(n, umi_len, 4)
    idx = np.arange(n, dtype=np.uint64) * np.uint64(7) if index is None else index
    records = JPL.encode_batch(bc, umi, idx, engine="host")
    h = Header.new(bc_len, umi_len)
    if sort:
        records = np.sort(records, order=("barcode", "umi", "index"))
        h.set_sorted()
    path = str(tmp_path / name)
    with Writer.from_path(path, h, compression=compression) as w:
        if n:
            w.write_batch(records)
    return path, bc, umi, idx


def decompressed(path):
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:2] == b"\x1f\x8b":
        return gzip.decompress(raw)
    if raw[:4] == b"\x28\xb5\x2f\xfd":
        import zstandard

        return zstandard.ZstdDecompressor().decompressobj().decompress(raw)
    return raw


# -- text blocks ------------------------------------------------------------

INDEX_CASES = {
    "mixed widths with 0 and u64 max": np.array(
        [0, 1, 9, 10, 12345, 10**19, 2**64 - 1], dtype=np.uint64),
    "one width": np.arange(1000, 1007, dtype=np.uint64),
    "u32 edge": np.array([2**32 - 1, 2**32, 2**32 + 1, 999_999_999, 10**9, 5, 7], np.uint64),
    "zeros": np.zeros(7, dtype=np.uint64),
}


@pytest.mark.parametrize("case", list(INDEX_CASES))
def test_decode_tsv_block_matches_jax_and_a_per_line_statement(case):
    idx = INDEX_CASES[case]
    bc, umi = rows(len(idx), 16, 5), rows(len(idx), 12, 6)
    got = TPL.decode_tsv_block(bc, umi, idx)
    assert got == JPL.decode_tsv_block(bc, umi, idx)
    assert got == "".join(
        f"{b.tobytes().decode()}\t{u.tobytes().decode()}\t{int(i)}\n"
        for b, u, i in zip(bc, umi, idx)).encode()


def test_decode_tsv_block_empty_and_large():
    bc, umi = rows(0, 16, 1), rows(0, 12, 2)
    assert TPL.decode_tsv_block(bc, umi, np.zeros(0, np.uint64)) == b""
    rng = np.random.default_rng(7)
    idx = rng.integers(0, 1 << 40, 20_000, dtype=np.uint64)
    bc, umi = rows(20_000, 7, 1), rows(20_000, 31, 2)
    assert TPL.decode_tsv_block(bc, umi, idx) == JPL.decode_tsv_block(bc, umi, idx)


@pytest.mark.parametrize("case", list(INDEX_CASES))
@pytest.mark.parametrize("qual", ["I", "!"])
def test_fastq_block_matches_jax(case, qual):
    idx = INDEX_CASES[case]
    bc, umi = rows(len(idx), 16, 5), rows(len(idx), 12, 6)
    got = TPL._fastq_block(bc, umi, idx, ord(qual))
    assert got == JPL._fastq_block(bc, umi, idx, ord(qual))
    lines = got.splitlines()
    assert lines[0] == b"@r" + str(int(idx[0])).encode().rjust(20, b"0")
    assert lines[1] == bytes(bc[0]) + bytes(umi[0]) and lines[2] == b"+"
    assert lines[3] == qual.encode() * 28 and len(got) == 83 * len(idx)
    assert TPL._NAME_DIGITS == JPL._NAME_DIGITS and np.array_equal(TPL._POW10, JPL._POW10)


# -- export -----------------------------------------------------------------

EXPORT_CASES = {
    "plain": ({}, "x.fastq", {}),
    "several batches": ({}, "x.fastq", {"batch_records": 128}),
    "gzip output": ({"n": 100}, "x.fastq.gz", {}),
    "zstd output": ({"n": 50}, "x.fastq.zst", {}),
    "qual !": ({"n": 4}, "x.fastq", {"qual": "!"}),
    "qual ~": ({"n": 4}, "x.fastq", {"qual": "~"}),
    "qual @": ({"n": 4}, "x.fastq", {"qual": "@"}),
    "record range": ({}, "x.fastq", {"record_range": (100, 333), "batch_records": 100}),
    "empty record range": ({}, "x.fastq", {"record_range": (5, 5)}),
    "gzip input": ({"name": "x.ibu.gz", "compression": "auto", "n": 3000}, "x.fastq",
                   {"batch_records": 1000}),
    "zstd input": ({"name": "x.ibu.zst", "compression": "auto", "n": 300}, "x.fastq", {}),
    "u64 max index": ({"n": 3, "bc_len": 4, "umi_len": 4,
                       "index": np.array([0, 2**64 - 1, 2**32], np.uint64)}, "x.fastq", {}),
    "bc32 umi32": ({"n": 77, "bc_len": 32, "umi_len": 32}, "x.fastq", {}),
    "empty file": ({"n": 0}, "x.fastq", {}),
}


@pytest.mark.parametrize("engine", ["device", "host"])
@pytest.mark.parametrize("case", list(EXPORT_CASES))
def test_export_fastq_matches_jax(tmp_path, monkeypatch, case, engine):
    if "zstd" in case:
        pytest.importorskip("zstandard")
    monkeypatch.setenv("IBU_AUTO_ENGINE", engine)
    make, out_name, kwargs = EXPORT_CASES[case]
    path, bc, umi, idx = ibu_file(tmp_path, **make)
    jo, to = str(tmp_path / f"j_{out_name}"), str(tmp_path / f"t_{out_name}")
    j = outcome(JPL.export_fastq, path, jo, **kwargs)
    t = outcome(TPL.export_fastq, path, to, device=CPU, **kwargs)
    assert j[0] == "ok"
    same(j, t)
    assert decompressed(jo) == decompressed(to)
    if case == "plain":
        lines = decompressed(to).splitlines()
        assert len(lines) == 4 * len(bc)
        for k in (0, 1, len(bc) - 1):
            assert lines[4 * k] == b"@r" + str(int(idx[k])).encode().rjust(20, b"0")
            assert lines[4 * k + 1] == bytes(bc[k]) + bytes(umi[k])
    if case == "gzip output":
        with open(to, "rb") as f:
            assert f.read(2) == b"\x1f\x8b"


@pytest.mark.parametrize("qual", ["", "II", "你", "\n", " ", "\x00", "\x7f"])
def test_export_fastq_bad_qual_matches_jax(tmp_path, qual):
    j = outcome(JPL.export_fastq, "x.ibu", str(tmp_path / "j.fastq"), qual=qual)
    t = outcome(TPL.export_fastq, "x.ibu", str(tmp_path / "t.fastq"), qual=qual, device=CPU)
    assert j[0] == "error" and "Phred" in j[2]
    same(j, t)


def test_export_fastq_compressed_input_with_record_range_matches_jax(tmp_path):
    path, *_ = ibu_file(tmp_path, n=10, name="x.ibu.gz", compression="auto")
    j = outcome(JPL.export_fastq, path, str(tmp_path / "j.fastq"), record_range=(0, 5))
    t = outcome(TPL.export_fastq, path, str(tmp_path / "t.fastq"), record_range=(0, 5),
                device=CPU)
    assert j[0] == "error" and "record_range needs random access" in j[2]
    same(j, t)


# -- the prefix parser ------------------------------------------------------


def crlf_fastq(path, n=503, seed=5):
    seqs = [bytes(r) for r in rows(n, 28, seed)]
    body = b"".join(b"@read%d\r\n%s\r\n+\r\n%s\r\n" % (i, s, b"I" * 28)
                    for i, s in enumerate(seqs))
    path.write_bytes(body[:-2])  # no final newline at all
    return np.frombuffer(b"".join(seqs), dtype=np.uint8).reshape(-1, 28)


def lf_fastq(path, n, seed=6, extra=13):
    seqs = rows(n, 28 + extra, seed)
    path.write_bytes(b"".join(b"@r%d\n%s\n+\n%s\n" % (i, bytes(s), b"I" * (28 + extra))
                              for i, s in enumerate(seqs)))
    return np.ascontiguousarray(seqs[:, :28])


def batches_of(module, *args, **kwargs):
    return [b.copy() for b in module.fastq_prefix_batches(*args, **kwargs)]


def same_batches(got, want):
    assert [b.shape for b in got] == [b.shape for b in want]
    assert all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(got, want))


def test_parser_crlf_no_final_newline_and_tiny_chunks(tmp_path, parser):
    fq = tmp_path / "b.fastq"
    want = crlf_fastq(fq)
    got = batches_of(TPL, str(fq), 28, batch=100, chunk_bytes=37)
    same_batches(got, batches_of(JPL, str(fq), 28, batch=100, chunk_bytes=37))
    assert [len(b) for b in got] == [100] * 5 + [3]
    assert np.array_equal(np.concatenate(got), want)


@pytest.mark.parametrize("batch,chunk_bytes", [(64, 1 << 12), (1000, 999), (7, 1 << 23), (250, 83)])
def test_parser_batch_boundary_inside_a_chunk(tmp_path, parser, batch, chunk_bytes):
    fq = tmp_path / "c.fastq"
    want = lf_fastq(fq, 1000)
    got = batches_of(TPL, str(fq), 28, batch=batch, chunk_bytes=chunk_bytes)
    same_batches(got, batches_of(JPL, str(fq), 28, batch=batch, chunk_bytes=chunk_bytes))
    assert np.array_equal(np.concatenate(got), want)
    assert all(len(b) == batch for b in got[:-1]) and all(b.flags.c_contiguous for b in got)


def test_parser_empty_name_plus_and_quality_lines(tmp_path, parser):
    fq = tmp_path / "empty_qual.fastq"
    fq.write_bytes(b"".join(b"@\n%s\n+\n\n" % (b"A" * 16) for _ in range(5000)))
    got = batches_of(TPL, str(fq), 16, batch=1024)
    same_batches(got, batches_of(JPL, str(fq), 16, batch=1024))
    assert np.concatenate(got).shape == (5000, 16) and (np.concatenate(got) == 65).all()


def test_parser_empty_file_and_no_sequence_line(tmp_path, parser):
    for name, body in (("e.fastq", b""), ("n.fastq", b"@r0"), ("n2.fastq", b"@r0\n")):
        fq = tmp_path / name
        fq.write_bytes(body)
        assert batches_of(TPL, str(fq), 28) == batches_of(JPL, str(fq), 28) == []


@pytest.mark.parametrize("chunk_bytes", [11, 1 << 23])
def test_parser_short_read_names_its_line(tmp_path, parser, chunk_bytes):
    fq = tmp_path / "ln.fastq"
    seq = b"ACGTACGTACGTACGTACGTACGTACGT"
    fq.write_bytes(b"@r0\n%s\n+\n%s\n@r1\nACG\r\n+\nIII\n" % (seq, b"I" * 28))
    j = outcome(batches_of, JPL, str(fq), 28, chunk_bytes=chunk_bytes)
    t = outcome(batches_of, TPL, str(fq), 28, chunk_bytes=chunk_bytes)
    assert j == ("error", "ValueError",
                 "read at line 6 is 3 bases, shorter than bc_len+umi_len=28")
    same(j, t)


def test_parser_short_last_line_without_newline(tmp_path, parser):
    fq = tmp_path / "last.fastq"
    fq.write_bytes(b"@r0\nACGT")
    j = outcome(batches_of, JPL, str(fq), 28)
    t = outcome(batches_of, TPL, str(fq), 28)
    assert j[0] == "error" and "line 2 is 4 bases" in j[2]
    same(j, t)


def line_starts(path):
    data = path.read_bytes()
    return [0] + [i + 1 for i, c in enumerate(data) if c == 10 and i + 1 < len(data)]


@pytest.mark.parametrize("chunk_bytes", [64, 1 << 23])
def test_parser_byte_range_cuts_cover_the_file_once(tmp_path, parser, chunk_bytes):
    fq = tmp_path / "r.fastq"
    want = lf_fastq(fq, 301, extra=0)
    starts = line_starts(fq)
    size = fq.stat().st_size
    # cuts at line starts that are not read starts, so a shard begins mid-read
    cut_lines = [0, 5, 402, 403, 1001, len(starts)]
    parts = []
    for a, b in zip(cut_lines, cut_lines[1:]):
        lo = starts[a]
        hi = starts[b] if b < len(starts) else size
        kwargs = dict(batch=50, chunk_bytes=chunk_bytes, byte_range=(lo, hi), line_base=a)
        got = batches_of(TPL, str(fq), 28, **kwargs)
        same_batches(got, batches_of(JPL, str(fq), 28, **kwargs))
        parts += got
    assert np.array_equal(np.concatenate(parts), want)


def test_parser_byte_range_end_inside_a_line_keeps_the_whole_line(tmp_path, parser):
    fq = tmp_path / "m.fastq"
    want = lf_fastq(fq, 40, extra=0)
    starts = line_starts(fq)
    # the range ends 3 bytes into read 10's sequence line: that line is owned
    kwargs = dict(byte_range=(0, starts[41] + 3), chunk_bytes=50)
    got = batches_of(TPL, str(fq), 28, **kwargs)
    same_batches(got, batches_of(JPL, str(fq), 28, **kwargs))
    assert np.array_equal(np.concatenate(got), want[:11])


def test_parser_byte_range_short_read_line_number_uses_line_base(tmp_path, parser):
    fq = tmp_path / "s.fastq"
    lf_fastq(fq, 3, extra=0)
    with open(fq, "ab") as f:
        f.write(b"@r3\nAC\n+\nII\n")
    starts = line_starts(fq)
    kwargs = dict(byte_range=(starts[8], fq.stat().st_size), line_base=8)
    j = outcome(batches_of, JPL, str(fq), 28, **kwargs)
    t = outcome(batches_of, TPL, str(fq), 28, **kwargs)
    assert j[0] == "error" and "line 14 is 2 bases" in j[2]
    same(j, t)


def test_parser_byte_range_refuses_compressed_like_jax(tmp_path):
    fq = tmp_path / "z.fastq"
    fq.write_bytes(gzip.compress(b"@r0\nACGT\n+\nIIII\n"))
    j = outcome(batches_of, JPL, str(fq), 4, byte_range=(0, 10))
    t = outcome(batches_of, TPL, str(fq), 4, byte_range=(0, 10))
    assert j[0] == "error" and "byte_range needs random access" in j[2]
    same(j, t)


@pytest.mark.parametrize("kind", ["gzip", "zstd"])
def test_parser_sniffs_compression_without_a_suffix(tmp_path, parser, kind):
    plain = tmp_path / "p.fastq"
    want = lf_fastq(plain, 500)
    if kind == "gzip":
        packed = gzip.compress(plain.read_bytes())
    else:
        zstandard = pytest.importorskip("zstandard")
        packed = zstandard.ZstdCompressor().compress(plain.read_bytes())
    sneaky = tmp_path / "sneaky.fastq"
    sneaky.write_bytes(packed)
    got = batches_of(TPL, str(sneaky), 28, batch=128, chunk_bytes=4096)
    same_batches(got, batches_of(JPL, str(sneaky), 28, batch=128, chunk_bytes=4096))
    assert np.array_equal(np.concatenate(got), want)


# -- ingest -----------------------------------------------------------------

INGEST_CASES = {
    "plain": ("b.ibu", 2000, {"batch": 777}),
    "default batch": ("b.ibu", 600, {}),
    "gzip output": ("b.ibu.gz", 300, {"batch": 100}),
    "zstd output": ("b.ibu.zst", 300, {"batch": 100}),
    "empty fastq": ("b.ibu", 0, {}),
    "no validation": ("b.ibu", 50, {"validate": False}),
}


@pytest.mark.parametrize("engine", ["auto", "device", "host"])
@pytest.mark.parametrize("case", list(INGEST_CASES))
def test_ingest_fastq_matches_jax(tmp_path, monkeypatch, parser, case, engine):
    out_name, n, kwargs = INGEST_CASES[case]
    if out_name.endswith(".zst"):
        pytest.importorskip("zstandard")
    if engine != "auto":
        monkeypatch.setenv("IBU_AUTO_ENGINE", engine)
    path, bc, umi, _ = ibu_file(tmp_path, n=n, sort=True)
    fq = str(tmp_path / "a.fastq")
    JPL.export_fastq(path, fq)
    jo, to = str(tmp_path / f"j_{out_name}"), str(tmp_path / f"t_{out_name}")
    j = outcome(JPL.ingest_fastq, fq, jo, 16, 12, **kwargs)
    t = outcome(TPL.ingest_fastq, fq, to, 16, 12, device=CPU, **kwargs)
    assert j == ("ok", n)
    same(j, t)
    assert decompressed(jo) == decompressed(to)
    left = sorted(p.name for p in tmp_path.iterdir())
    assert left == sorted(["x.ibu", "a.fastq", f"j_{out_name}", f"t_{out_name}"])
    if case == "plain":
        # export writes reads in sorted order, so ingest's read numbers are
        # the ranks: the file comes back with arange as its index column
        with open(path, "rb") as f:
            want = bytearray(f.read())
        back = np.frombuffer(want, dtype=JPL.MmapReader(path).records.dtype, offset=32)
        back["index"] = np.arange(n, dtype=np.uint64)
        assert decompressed(to) == bytes(want)


def test_ingest_with_and_without_native_write_the_same_bytes(tmp_path, monkeypatch):
    if not TN.available():
        pytest.skip("native runtime unavailable")
    path, *_ = ibu_file(tmp_path, n=5000, sort=True)
    fq = str(tmp_path / "a.fastq")
    TPL.export_fastq(path, fq, device=CPU)
    with_native = str(tmp_path / "n.ibu")
    assert TPL.ingest_fastq(fq, with_native, 16, 12, batch=999, device=CPU) == 5000
    monkeypatch.setattr(TN, "available", lambda: False)
    TSEL.reset_probe_memo()
    without = str(tmp_path / "w.ibu")
    assert TPL.ingest_fastq(fq, without, 16, 12, batch=999, device=CPU) == 5000
    same_files(with_native, without)


def test_ingest_spills_several_runs_and_merges_them(tmp_path):
    """More than one 32 MB chunk (1,398,101 records): two sorted runs and the
    key-range-parallel merge, against the JAX package and a numpy sort."""
    if not (TN.available() and JN.available()):
        pytest.skip("native runtime unavailable")
    n = 1_450_000
    bc, umi = rows(n, 16, 11), rows(n, 12, 12)
    fq = str(tmp_path / "big.fastq")
    with open(fq, "wb") as f:
        f.write(TPL._fastq_block(bc, umi, np.arange(n, dtype=np.uint64), ord("I")))
    jo, to = str(tmp_path / "j.ibu"), str(tmp_path / "t.ibu")
    assert JPL.ingest_fastq(fq, jo, 16, 12) == n
    assert TPL.ingest_fastq(fq, to, 16, 12, device=CPU) == n
    same_files(jo, to)
    got = np.asarray(TPL.MmapReader(to).records)
    want = np.sort(TPL.encode_batch(bc, umi, np.arange(n, dtype=np.uint64), engine="host"),
                   order=("barcode", "umi", "index"))
    assert np.array_equal(got, want)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["big.fastq", "j.ibu", "t.ibu"]


INGEST_ERRORS = {
    "short read": (b"@r0\nACGT\n+\nIIII\n", "shorter than"),
    "short read after good ones": (
        b"".join(b"@r%d\n%s\n+\n%s\n" % (i, b"ACGT" * 7, b"I" * 28) for i in range(9))
        + b"@r9\nACGTACGT\n+\nIIIIIIII\n", "line 38 is 8 bases"),
    "an N in the prefix": (b"@r0\n%s\n+\n%s\n" % (b"ACGN" * 7, b"I" * 28), "invalid nucleotide"),
}


@pytest.mark.parametrize("case", list(INGEST_ERRORS))
def test_ingest_fastq_errors_match_jax_and_leave_nothing(tmp_path, parser, case):
    body, match = INGEST_ERRORS[case]
    fq = tmp_path / "s.fastq"
    fq.write_bytes(body)
    j = outcome(JPL.ingest_fastq, str(fq), str(tmp_path / "j.ibu"), 16, 12, batch=4)
    t = outcome(TPL.ingest_fastq, str(fq), str(tmp_path / "t.ibu"), 16, 12, batch=4, device=CPU)
    assert j[0] == "error" and match in j[2]
    same(j, t)
    assert [p.name for p in tmp_path.iterdir()] == ["s.fastq"]


def test_ingest_failed_merge_unlinks_runs_and_output(tmp_path, monkeypatch):
    if not TN.available():
        pytest.skip("native runtime unavailable")
    fq = tmp_path / "m.fastq"
    lf_fastq(fq, 100)

    def boom(*a, **k):
        raise OSError(5, "injected merge failure")

    monkeypatch.setattr(TN, "merge_runs_interval", boom)
    for out_name in ("o.ibu", "o.ibu.gz"):
        with pytest.raises(OSError, match="injected"):
            TPL.ingest_fastq(str(fq), str(tmp_path / out_name), 16, 12, device=CPU)
        assert [p.name for p in tmp_path.iterdir()] == ["m.fastq"]


def test_ingest_sniffs_gzip_fastq_like_jax(tmp_path):
    plain = tmp_path / "p.fastq"
    lf_fastq(plain, 64)
    sneaky = tmp_path / "sneaky.fastq"
    sneaky.write_bytes(gzip.compress(plain.read_bytes()))
    outs = {}
    for tag, src in (("a", plain), ("b", sneaky)):
        outs[tag] = str(tmp_path / f"{tag}.ibu")
        assert TPL.ingest_fastq(str(src), outs[tag], 16, 12, device=CPU) == 64
    same_files(outs["a"], outs["b"])
    jo = str(tmp_path / "j.ibu")
    assert JPL.ingest_fastq(str(sneaky), jo, 16, 12) == 64
    same_files(jo, outs["b"])


# -- the slice as a whole ---------------------------------------------------


def test_slice_as_a_whole_matches_jax_file_by_file(tmp_path, parser):
    """export_fastq → ingest_fastq → filter_file → dedup_file on both
    packages, every file compared."""
    n = 6000
    rng = np.random.default_rng(21)
    pool = rng.integers(0, 1 << 32, 300, dtype=np.uint64)
    records = np.sort(make_records(pool[rng.integers(0, 300, n)],
                                   rng.integers(0, 40, n).astype(np.uint64),
                                   np.arange(n, dtype=np.uint64)),
                      order=("barcode", "umi", "index"))
    h = Header.new(16, 12)
    h.set_sorted()
    src = str(tmp_path / "src.ibu")
    with Writer.from_path(src, h) as w:
        w.write_batch(records)
    allow = pool[:100]
    files = {}
    for tag, module, dev in (("j", JPL, {}), ("t", TPL, {"device": CPU})):
        fq, back, kept, mol = (str(tmp_path / f"{tag}.{ext}")
                               for ext in ("fastq", "back.ibu", "kept.ibu", "mol.ibu"))
        counts = [module.export_fastq(src, fq, batch_records=2048, **dev),
                  module.ingest_fastq(fq, back, 16, 12, batch=1000, **dev),
                  module.filter_file(back, kept, allow, batch_records=1500),
                  module.dedup_file(kept, mol, batch_records=700, **dev)]
        files[tag] = ((fq, back, kept, mol), counts)
    assert files["t"][1] == files["j"][1]
    for a, b in zip(files["j"][0], files["t"][0]):
        same_files(a, b)
    assert files["t"][1][0] == files["t"][1][1] == n
    assert files["t"][1][3]["molecules"] < files["t"][1][2]["kept"] < n


# -- the examples -----------------------------------------------------------


def untimed(text):
    """The printed lines without their timings and rates."""
    lines = [l for l in text.splitlines() if not l.startswith("codec engine auto")]
    return [re.sub(r"[\d.]+ ?(s\b|M records/s|M reads/s|GB/s|MB)", "_", l) for l in lines
            if not re.match(r"\s*(Duration|Rate|Bandwidth):", l)]


def run_reference(script, *argv, cwd):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, str(REPO / "examples" / script), *argv], cwd=cwd,
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_fastq_ingest_example_prints_the_reference_lines(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert TFI.main(["--device", "cpu", "--reads", "20000"]) == 0
    got = untimed(capsys.readouterr().out)
    want = untimed(run_reference("fastq_ingest.py", "--reads", "20000", cwd=tmp_path))
    assert got == want and any("verified: 20000 records" in l for l in got)
    assert not list(tmp_path.iterdir())


def test_fastq_ingest_example_generator_and_wrapper_match_the_reference(tmp_path):
    import importlib.util as iu

    spec = iu.spec_from_file_location("ref_fastq_ingest", REPO / "examples" / "fastq_ingest.py")
    ref = iu.module_from_spec(spec)
    saved = list(sys.path)
    try:
        spec.loader.exec_module(ref)
    finally:
        sys.path[:] = saved
    a, b = str(tmp_path / "a.fastq"), str(tmp_path / "b.fastq")
    ref.synth_fastq(a, 1234, 28, seed=3)
    TFI.synth_fastq(b, 1234, 28, seed=3)
    same_files(a, b)
    same_batches(list(TFI.fastq_prefixes(b, 28, batch=500)),
                 list(ref.fastq_prefixes(a, 28, batch=500)))


def test_roundtrip_example_prints_the_reference_lines(tmp_path, capsys):
    argv = ["--records", "0.05", "--file", str(tmp_path / "rt.ibu")]
    assert TRT.main(["--device", "cpu", *argv]) == 0
    got = untimed(capsys.readouterr().out)
    want = untimed(run_reference("roundtrip.py", *argv, cwd=tmp_path))
    assert got == want
    assert any(l.startswith("  Checksum: 0x") for l in got)
    assert not (tmp_path / "rt.ibu").exists()


@pytest.mark.parametrize("n", [0, 1, 2, 3, 1000, 49152])
def test_roundtrip_example_xor_checksum_is_numpy_s(n):
    import torch

    batch = TRT.patterned_batch(5, n)
    want = 0
    for f in ("barcode", "umi", "index"):
        want ^= int(np.bitwise_xor.reduce(batch[f])) if n else 0
    assert TRT.xor_checksum(batch, torch.device("cpu")) == want
