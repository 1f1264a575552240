"""The port against the golden corpus of ``tests/fixtures/``, the counterpart
of ``tests/test_golden_fixtures.py``.

The 17 files are encoded by hand from the wire spec (``tools/make_fixtures.py``,
plain ``struct.pack``), so they check the format against the spec and not
against either package's reading of it. Every class of the reference's file
runs here through the port's ``Writer``, ``Reader``, ``MmapReader``,
``load_to_vec`` and codec (``device="cpu"``); each fixture through each reader
must give ``ibu_tpu``'s header and record bytes, or its error type and text;
and the port's ``Writer`` re-encodes every readable fixture to its own bytes.
"""

import os

import numpy as np
import pytest

import ibu_tpu
import ibu_tpu_torch
from ibu_tpu import pipelines as JPL
from ibu_tpu_torch import (
    RECORD_DTYPE,
    Header,
    InvalidBarcodeLength,
    InvalidMagicNumber,
    InvalidMapSize,
    InvalidUmiLength,
    InvalidVersion,
    MmapReader,
    Reader,
    TruncatedRecord,
    Writer,
    load_to_vec,
    make_records,
)
from ibu_tpu_torch import pipelines as TPL

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
PLAIN = ["allT32.ibu", "empty_bc16_umi12.ibu", "len1.ibu", "len16.ibu", "len17.ibu", "len32.ibu",
         "one_record.ibu", "sorted_bc4_umi8.ibu", "umax.ibu", "unsorted_bc4_umi8.ibu"]
COMPRESSED = ["one_record.ibu.gz", "one_record.ibu.zst"]
CORRUPT = ["bad_bc_len.ibu", "bad_umi_len.ibu", "corrupt_magic.ibu", "corrupt_version.ibu",
           "truncated_tail.ibu"]
ALL = PLAIN + COMPRESSED + CORRUPT


def fixture(name: str) -> bytes:
    with open(os.path.join(FIXDIR, name), "rb") as f:
        return f.read()


def copy(tmp_path, name: str) -> str:
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(fixture(name))
    return p


def write_bytes(header: Header, records: np.ndarray) -> bytes:
    w = Writer.in_memory(header)
    w.write_batch(records)
    w.finish()
    return w.inner.getvalue()


def pack2bit(seq: str) -> int:
    word = 0
    for i, base in enumerate(seq):
        word |= {"A": 0, "C": 1, "G": 2, "T": 3}[base] << (2 * i)
    return word


def seq_of(length: int, phase: int) -> str:
    return "".join("ACGT"[(i + phase) % 4] for i in range(length))


def test_the_corpus_is_every_fixture():
    assert sorted(ALL) == sorted(os.listdir(FIXDIR)) and len(ALL) == 17


class TestWriterProducesGoldenBytes:
    def test_empty(self):
        assert write_bytes(Header.new(16, 12), np.empty(0, dtype=RECORD_DTYPE)) == fixture(
            "empty_bc16_umi12.ibu")

    def test_one_record(self):
        recs = make_records(np.array([0x0123456789ABCDEF], np.uint64),
                            np.array([0x0000FEDCBA987654], np.uint64), np.array([7], np.uint64))
        assert write_bytes(Header.new(16, 12), recs) == fixture("one_record.ibu")

    def test_sorted_flag_and_order(self):
        triples = [(pack2bit(seq_of(4, k)), pack2bit(seq_of(8, k + 1)), 2 - k) for k in range(3)]
        arr = make_records(*[np.array(col, np.uint64) for col in zip(*triples)])
        h = Header.new(4, 8)
        assert write_bytes(h, arr) == fixture("unsorted_bc4_umi8.ibu")
        h.set_sorted()
        srt = np.sort(arr, order=("barcode", "umi", "index"))
        assert write_bytes(h, srt) == fixture("sorted_bc4_umi8.ibu")

    def test_umax(self):
        mx = np.array([0xFFFFFFFFFFFFFFFF, 0], np.uint64)
        assert write_bytes(Header.new(16, 12), make_records(mx, mx, mx)) == fixture("umax.ibu")

    @pytest.mark.parametrize("L", [1, 16, 17, 32])
    def test_codec_boundary_lengths(self, L):
        """The port's device codec (the plain versions on the CPU) packs the
        hand-packed words at every hi/lo-word boundary length."""
        def rows(s):
            return np.frombuffer(s.encode(), np.uint8)[None, :]

        recs = TPL.encode_batch(rows(seq_of(L, 0)), rows(seq_of(L, 3)), np.array([L], np.uint64),
                                engine="device", device="cpu")
        assert write_bytes(Header.new(L, L), recs) == fixture(f"len{L}.ibu")

    def test_bit63_all_t(self):
        rows = np.full((1, 32), ord("T"), np.uint8)
        recs = TPL.encode_batch(rows, rows, np.array([0xFFFFFFFFFFFFFFFF], np.uint64),
                                engine="device", device="cpu")
        assert write_bytes(Header.new(32, 32), recs) == fixture("allT32.ibu")


def outcome(read, pkg, path):
    """``("ok", header bytes, record bytes)`` or ``("error", class name,
    text)`` of one reader of ``pkg`` over ``path``."""
    try:
        if read == "stream":
            r = pkg.Reader.from_path(path)
            batches = list(r.batches())
            recs = np.concatenate(batches) if batches else np.empty(0, pkg.RECORD_DTYPE)
            header = r.header()
        elif read == "mmap":
            m = pkg.MmapReader(path)
            header, recs = m.header(), np.asarray(m.records)
        else:
            header, recs = pkg.load_to_vec(path)
        return ("ok", header.as_bytes(), recs.tobytes())
    except Exception as e:  # noqa: BLE001 (the error is the result compared)
        return ("error", type(e).__name__, str(e))


@pytest.mark.parametrize("read", ["stream", "mmap", "bulk"])
@pytest.mark.parametrize("name", ALL)
def test_each_reader_of_each_fixture_equals_the_reference(tmp_path, name, read):
    if name.endswith(".zst"):
        pytest.importorskip("zstandard")
    path = copy(tmp_path, name)
    got = outcome(read, ibu_tpu_torch, path)
    assert got == outcome(read, ibu_tpu, path)
    readable = name in PLAIN or (name in COMPRESSED and read == "stream")
    assert (got[0] == "ok") == readable, got
    if readable:
        assert got[1] + got[2] == fixture(name.split(".ibu")[0] + ".ibu")


@pytest.mark.parametrize("name", PLAIN)
def test_the_writer_re_encodes_each_fixture(tmp_path, name):
    header, recs = load_to_vec(copy(tmp_path, name))
    assert write_bytes(header, recs) == fixture(name)
    out = str(tmp_path / "again.ibu")
    with Writer.from_path(out, header) as w:
        w.write_batch(recs)
    assert open(out, "rb").read() == fixture(name)


class TestReadersParseGoldenBytes:
    @pytest.mark.parametrize("name", ["one_record.ibu", "umax.ibu", "sorted_bc4_umi8.ibu",
                                      "len32.ibu"])
    def test_three_readers_agree(self, name, tmp_path):
        p = copy(tmp_path, name)
        stream = np.concatenate(list(Reader.from_path(p).batches()))
        _, bulk = load_to_vec(p)
        mm = np.asarray(MmapReader(p).records)
        assert np.array_equal(stream, bulk) and np.array_equal(bulk, mm)

    def test_one_record_values(self, tmp_path):
        h, recs = load_to_vec(copy(tmp_path, "one_record.ibu"))
        assert (h.bc_len, h.umi_len, h.sorted()) == (16, 12, False)
        assert int(recs[0]["barcode"]) == 0x0123456789ABCDEF
        assert int(recs[0]["umi"]) == 0x0000FEDCBA987654
        assert int(recs[0]["index"]) == 7

    def test_sorted_flag_read(self, tmp_path):
        p = copy(tmp_path, "sorted_bc4_umi8.ibu")
        assert MmapReader(p).header().sorted()
        b = np.asarray(MmapReader(p).records)["barcode"]
        assert list(b) == sorted(b)

    @pytest.mark.parametrize("L", [1, 16, 17, 32])
    def test_decode_recovers_sequences(self, L, tmp_path):
        p = copy(tmp_path, f"len{L}.ibu")
        header, bc, umi, idx = TPL.decode_file(p, as_strings=True, device="cpu")
        assert bc == [seq_of(L, 0)] and umi == [seq_of(L, 3)]
        assert int(idx[0]) == L
        _, jbc, jumi, jidx = JPL.decode_file(p, as_strings=True)
        assert (bc, umi, idx.tolist()) == (jbc, jumi, np.asarray(jidx).tolist())
        assert header.as_bytes() == fixture(f"len{L}.ibu")[:32]


class TestCompressedFixtures:
    def test_gzip_roundtrip(self, tmp_path):
        got = np.concatenate(list(Reader.from_path(copy(tmp_path, "one_record.ibu.gz")).batches()))
        assert got.tobytes() == fixture("one_record.ibu")[32:]

    def test_zstd_roundtrip(self, tmp_path):
        pytest.importorskip("zstandard")
        got = np.concatenate(list(Reader.from_path(copy(tmp_path, "one_record.ibu.zst")).batches()))
        assert got.tobytes() == fixture("one_record.ibu")[32:]

    @pytest.mark.parametrize("name", COMPRESSED)
    def test_mmap_and_bulk_do_not_decompress(self, tmp_path, name):
        """mmap and bulk load read raw files (reference parity): compressed
        bytes are a bad magic, with the reference's text."""
        p = copy(tmp_path, name)
        for port, ref in ((MmapReader, ibu_tpu.MmapReader), (load_to_vec, ibu_tpu.load_to_vec)):
            with pytest.raises(InvalidMagicNumber) as ei:
                port(p)
            with pytest.raises(ibu_tpu.InvalidMagicNumber) as ej:
                ref(p)
            assert str(ei.value) == str(ej.value)


class TestCorruptionFixtures:
    """Exact error types, payloads and texts (``error.rs:56-128``)."""

    def test_corrupt_magic(self, tmp_path):
        p = copy(tmp_path, "corrupt_magic.ibu")
        with pytest.raises(InvalidMagicNumber) as ei:
            Reader.from_path(p)
        assert ei.value.expected == 0x21554249
        assert ei.value.actual == 0x21554248  # byte 0 bit-flipped
        assert "expected (0x21554249), found (0x21554248)" in str(ei.value)
        with pytest.raises(InvalidMagicNumber):
            MmapReader(p)
        with pytest.raises(InvalidMagicNumber):
            load_to_vec(p)

    def test_corrupt_version(self, tmp_path):
        with pytest.raises(InvalidVersion) as ei:
            Reader.from_path(copy(tmp_path, "corrupt_version.ibu"))
        assert (ei.value.expected, ei.value.actual) == (2, 99)
        assert "expected (2), found (99)" in str(ei.value)

    def test_bad_lengths(self, tmp_path):
        with pytest.raises(InvalidBarcodeLength) as ei:
            Reader.from_path(copy(tmp_path, "bad_bc_len.ibu"))
        assert "33" in str(ei.value)
        with pytest.raises(InvalidUmiLength) as ei:
            Reader.from_path(copy(tmp_path, "bad_umi_len.ibu"))
        assert "0" in str(ei.value)

    def test_truncated_tail_positions(self, tmp_path):
        """Streaming reports ``TruncatedRecord`` at the byte offset of the
        first incomplete record (32 + 2 x 24 = 80); mmap and bulk load
        report ``InvalidMapSize``."""
        p = copy(tmp_path, "truncated_tail.ibu")
        with pytest.raises(TruncatedRecord) as ei:
            list(Reader.from_path(p))
        assert ei.value.pos == 80
        assert "position 80" in str(ei.value)
        with pytest.raises(ibu_tpu.TruncatedRecord) as ej:
            list(ibu_tpu.Reader.from_path(p))
        assert str(ei.value) == str(ej.value)
        with pytest.raises(InvalidMapSize):
            MmapReader(p)
        with pytest.raises(InvalidMapSize):
            load_to_vec(p)
