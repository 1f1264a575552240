"""The port's own host layer against ``ibu_tpu``'s, on the CPU.

``ibu_tpu_torch`` carries copies of the framework-free host modules of
``ibu_tpu`` (header, records, reader, writer, mmap reader, compression,
errors and the native host runtime). Here the same seeded inputs go through
both: headers must serialize to the same bytes, the two writers must write
byte-identical files (plain, gzip and, where ``zstandard`` is installed,
zstd), each package must read the other's files, the errors must be the same
classes with the same messages, and the native codec and field sums must
equal the reference's and numpy's. Headers are compared by their bytes or
fields, never by class.
"""

import gzip
import io
import os

import numpy as np
import pytest

import ibu_tpu
import ibu_tpu.native as JN
import ibu_tpu_torch as T
from ibu_tpu.io.reader import load_to_vec as j_load_to_vec
from ibu_tpu_torch import errors as TE
from ibu_tpu_torch import native as TN
from ibu_tpu_torch import pipelines as TPL
from ibu_tpu_torch.io.reader import load_to_vec as t_load_to_vec
from ibu_tpu_torch.ops.codec import np_pack, np_unpack

PACKAGES = {"torch": (T, t_load_to_vec), "jax": (ibu_tpu, j_load_to_vec)}
COMPRESSIONS = [None, "gzip", "zstd"]
SUFFIX = {None: ".ibu", "gzip": ".ibu.gz", "zstd": ".ibu.zst"}


def random_records(n, seed):
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, 1 << 64, n, dtype=np.uint64) for _ in range(3)]
    cols[0][:2] = (0, (1 << 64) - 1)[: min(n, 2)]
    return T.make_records(*cols)


def need(compression):
    if compression == "zstd":
        pytest.importorskip("zstandard")


def write(pkg, path, records, header, compression=None, batches=3):
    with pkg.Writer.from_path(str(path), header, compression=compression) as w:
        for part in np.array_split(records, batches):
            w.write_batch(part)
        if len(records):
            w.write_batch([pkg.constructs.record.Record(1, 2, 3)])


# ---------------------------------------------------------------------------
# header
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bc_len,umi_len,sorted_flag", [(16, 12, False), (16, 12, True),
                                                         (1, 32, False), (32, 1, True)])
def test_header_bytes_match(bc_len, umi_len, sorted_flag):
    got, want = T.Header.new(bc_len, umi_len), ibu_tpu.Header.new(bc_len, umi_len)
    if sorted_flag:
        got.set_sorted()
        want.set_sorted()
    assert got.as_bytes() == want.as_bytes()
    back = T.Header.from_bytes(want.as_bytes())
    assert (back.bc_len, back.umi_len, back.sorted()) == (bc_len, umi_len, sorted_flag)
    assert hash(back) == hash(got)


def test_header_validation_errors_match():
    cases = [dict(magic=0x12345678), dict(version=3), dict(bc_len=0), dict(bc_len=33),
             dict(umi_len=0), dict(umi_len=40), dict(magic=1, bc_len=0)]
    for fields in cases:
        base = dict(bc_len=16, umi_len=12) | fields
        with pytest.raises(ibu_tpu.IbuError) as want:
            ibu_tpu.Header(**base).validate()
        with pytest.raises(TE.IbuError) as got:
            T.Header(**base).validate()
        assert type(got.value).__name__ == type(want.value).__name__
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# writers: byte-identical files
# ---------------------------------------------------------------------------


@pytest.fixture
def fixed_gzip_mtime(monkeypatch):
    """gzip stamps the write time into its header; pin it for both writers."""
    monkeypatch.setattr(gzip.time, "time", lambda: 1_700_000_000.0)


@pytest.mark.parametrize("compression", COMPRESSIONS)
@pytest.mark.parametrize("n", [0, 1, 5000, 60_000])
def test_writers_write_identical_files(tmp_path, fixed_gzip_mtime, compression, n):
    need(compression)
    records = random_records(n, n)
    paths = {}
    for name, (pkg, _) in PACKAGES.items():
        (tmp_path / name).mkdir()
        paths[name] = tmp_path / name / f"x{SUFFIX[compression]}"
        header = pkg.Header.new(16, 12)
        header.set_sorted()
        write(pkg, paths[name], records, header, compression)
    assert paths["torch"].read_bytes() == paths["jax"].read_bytes()


@pytest.mark.parametrize("buffer_size", [24, 1000, 1 << 20])
def test_stream_writers_match(buffer_size):
    """Records, record iterables and single records through small and large
    buffers into an in-memory sink."""
    records = random_records(1000, 3)
    out = {}
    for name, (pkg, _) in PACKAGES.items():
        w = pkg.Writer(io.BytesIO(), pkg.Header.new(20, 10), buffer_size=buffer_size)
        w.write_batch(records[:400])
        w.write_batch(pkg.constructs.record.Record(i, i + 1, i + 2) for i in range(5))
        w.write_batch(records[400:])
        w.write_record(pkg.constructs.record.Record(7, 8, 9))
        w.close()
        out[name] = (w.inner.getvalue(), w.records_written)
    assert out["torch"] == out["jax"] and out["torch"][1] == 1006
    with pytest.raises(ValueError, match="write_batch expects dtype"):
        T.Writer(io.BytesIO(), None).write_batch(np.zeros(3, np.uint64))


# ---------------------------------------------------------------------------
# readers: each package reads the other's files
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compression", COMPRESSIONS)
@pytest.mark.parametrize("writer", list(PACKAGES))
def test_readers_read_the_other_packages_files(tmp_path, compression, writer):
    need(compression)
    records = random_records(70_000, 11)
    path = tmp_path / f"x{SUFFIX[compression]}"
    wpkg = PACKAGES[writer][0]
    write(wpkg, path, records, wpkg.Header.new(16, 12), compression, batches=1)
    want = np.concatenate([records, T.make_records([1], [2], [3])])
    for name, (pkg, load) in PACKAGES.items():
        reader = pkg.Reader.from_path(str(path))
        assert reader.header().as_bytes() == wpkg.Header.new(16, 12).as_bytes()
        got = np.concatenate(list(reader.batches()))
        assert got.tobytes() == want.tobytes(), name
        assert reader.bytes_read == 32 + 24 * len(want)
        if compression is None:
            mm = pkg.MmapReader(str(path))
            assert mm.len() == len(want) and mm.header().bc_len == 16
            assert np.asarray(mm.records).tobytes() == want.tobytes()
            assert np.array_equal(mm.slice(5, 9)["umi"], want["umi"][5:9])
            header, loaded = load(str(path))
            assert header.as_bytes() == mm.header().as_bytes()
            assert loaded.tobytes() == want.tobytes()


def test_record_iterator_matches(tmp_path):
    path = tmp_path / "r.ibu"
    write(ibu_tpu, path, random_records(300, 12), ibu_tpu.Header.new(16, 12))
    got = [(r.barcode, r.umi, r.index) for r in T.Reader.from_path(str(path))]
    want = [(r.barcode, r.umi, r.index) for r in ibu_tpu.Reader.from_path(str(path))]
    assert got == want and len(got) == 301


# ---------------------------------------------------------------------------
# errors: same class, same message
# ---------------------------------------------------------------------------


def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the test compares whatever was raised
        return type(e).__name__, str(e), getattr(e, "pos", None)
    return None


def _bad_files(tmp_path):
    good = tmp_path / "good.ibu"
    write(ibu_tpu, good, random_records(10, 13), ibu_tpu.Header.new(16, 12), batches=1)
    data = good.read_bytes()
    files = {
        "truncated record": data[:-5],
        "zero-byte file": b"",
        "short header": data[:20],
        "bad magic": b"XXXX" + data[4:],
        "bad version": data[:4] + (9).to_bytes(4, "little") + data[8:],
        "bad barcode length": data[:8] + (33).to_bytes(4, "little") + data[12:],
    }
    paths = {}
    for name, content in files.items():
        paths[name] = tmp_path / (name.replace(" ", "_") + ".ibu")
        paths[name].write_bytes(content)
    gz = tmp_path / "torn.ibu.gz"
    gz.write_bytes(gzip.compress(data)[:-12])
    paths["torn gzip"] = gz
    return paths


@pytest.mark.parametrize("opener", ["Reader", "MmapReader", "load_to_vec"])
def test_errors_match(tmp_path, opener):
    def open_with(name, path):
        pkg, load = PACKAGES[name]
        if opener == "Reader":
            return lambda: list(pkg.Reader.from_path(str(path)).batches())
        if opener == "MmapReader":
            return lambda: pkg.MmapReader(str(path))
        return lambda: load(str(path))

    for case, path in _bad_files(tmp_path).items():
        if opener != "Reader" and case == "torn gzip":
            continue
        want = _error(open_with("jax", path))
        got = _error(open_with("torch", path))
        assert want is not None, (case, opener)
        assert got == want, (case, opener)


def test_error_classes_and_messages_match():
    args = {"IbuIoError": ("x",), "CompressionError": ("x",), "InvalidMagicNumber": (1, 2),
            "TruncatedRecord": (56,), "InvalidVersion": (2, 3), "InvalidBarcodeLength": (33,),
            "InvalidUmiLength": (0,), "InvalidMapSize": (), "InvalidIndex": (9, 3),
            "ProcessError": ("boom",)}
    from ibu_tpu import errors as JE

    for name, a in args.items():
        got, want = getattr(TE, name)(*a), getattr(JE, name)(*a)
        assert str(got) == str(want) and isinstance(got, TE.IbuError)


def test_slice_bounds_match(tmp_path):
    path = tmp_path / "s.ibu"
    write(ibu_tpu, path, random_records(3, 14), ibu_tpu.Header.new(16, 12), batches=1)
    assert len(T.MmapReader(str(path)).slice(3, 4)) == 1  # 4 records: 3 and the Record
    for start, end in [(0, 9), (4, 4), (2, 1), (4, 5)]:
        got = _error(lambda: T.MmapReader(str(path)).slice(start, end))
        want = _error(lambda: ibu_tpu.MmapReader(str(path)).slice(start, end))
        assert got == want and got[0] == "InvalidIndex"


# ---------------------------------------------------------------------------
# the native host runtime
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def both_native():
    if not TN.available():
        pytest.fail(f"the port's host library did not build: {TN.load_error()}")
    if not JN.available():
        pytest.skip(f"the reference's native runtime is unavailable: {JN.load_error()}")


@pytest.mark.parametrize("n", [0, 1000, 70_001])  # 70,001 rows take the threaded path
@pytest.mark.parametrize("length", [1, 16, 32])
def test_native_codec_matches(both_native, n, length):
    rng = np.random.default_rng(length * 7 + n)
    rows = np.frombuffer(b"ACGTacgt", np.uint8)[rng.integers(0, 8, (n, length))]
    words = TN.pack_2bit(rows)
    assert np.array_equal(words, JN.pack_2bit(rows))
    assert np.array_equal(words, np_pack(rows))
    noise = rng.integers(0, 1 << 64, n, dtype=np.uint64)  # bits above 2L are ignored
    for w in (words, noise):
        assert np.array_equal(TN.unpack_2bit(w, length), JN.unpack_2bit(w, length))
        assert np.array_equal(TN.unpack_2bit(w, length), np_unpack(w, length))
    assert np.array_equal(TN.pack_2bit(rows, nthreads=1), words)


def test_native_pack_validation_matches(both_native):
    rows = np.frombuffer(b"ACGTACGN" * 10, np.uint8).reshape(10, 8)
    for native in (TN, JN):
        with pytest.raises(ValueError, match="invalid nucleotide or length in pack_2bit"):
            native.pack_2bit(rows)
    assert np.array_equal(TN.pack_2bit(rows, validate=False), JN.pack_2bit(rows, validate=False))


@pytest.mark.parametrize("n,nthreads", [(0, 0), (1, 0), (100_003, 0), (100_003, 3)])
def test_native_checksum_matches(both_native, tmp_path, n, nthreads):
    records = random_records(n, 15)
    path = str(tmp_path / "c.ibu")
    write(T, path, records, T.Header.new(16, 12), batches=1)
    n_all = n + (1 if n else 0)
    want = JN.checksum_parallel(path, n_all, nthreads)
    assert TN.checksum_parallel(path, n_all, nthreads) == want
    recs = T.MmapReader(path).records
    assert want == tuple(int(recs[f].sum(dtype=object)) % (1 << 64)
                         for f in ("barcode", "umi", "index"))
    with pytest.raises(OSError):
        TN.checksum_parallel(path, n_all + 1)


def test_native_library_is_its_own(both_native):
    path = TN.library_path()
    assert path.exists() and path.name.startswith("libibu_host_")
    assert path.parent.name == "ibu_tpu_torch" and path.parent.parent.name == "build"


def test_host_engine_falls_back_to_numpy(monkeypatch):
    rng = np.random.default_rng(16)
    bc = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (500, 16))]
    umi = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (500, 12))]
    idx = np.arange(500, dtype=np.uint64)
    native = TPL.encode_batch(bc, umi, idx, engine="host")
    monkeypatch.setattr(TN, "available", lambda: False)
    fallback = TPL.encode_batch(bc, umi, idx, engine="host")
    assert fallback.tobytes() == native.tobytes()
    got = TPL.decode_batch(fallback, 16, 12, engine="host")
    assert np.array_equal(got[0], bc) and np.array_equal(got[1], umi)


def test_native_unavailable_is_reported(monkeypatch, tmp_path):
    monkeypatch.setattr(TN, "_lib", None)
    monkeypatch.setattr(TN, "_load_error", None)
    monkeypatch.setattr(TN, "build", lambda: (_ for _ in ()).throw(TN.NativeBuildError("no g++")))
    assert not TN.available() and TN.load_error() == "no g++"
    path = str(tmp_path / "n.ibu")
    write(T, path, random_records(4, 17), T.Header.new(16, 12), batches=1)
    with pytest.raises(RuntimeError, match="native runtime unavailable: no g\\+\\+"):
        TPL.file_stats(path, engine="native")
    assert os.path.exists(path)
