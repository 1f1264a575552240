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


# ---------------------------------------------------------------------------
# native functions of the FASTQ slice: both libraries on the same inputs
# ---------------------------------------------------------------------------

NATIVES = {"torch": TN, "jax": JN}


def keyed_records(n, seed, hi=1 << 60):
    rng = np.random.default_rng(seed)
    return T.make_records(rng.integers(0, hi, n, dtype=np.uint64),
                          rng.integers(0, hi, n, dtype=np.uint64),
                          np.arange(n, dtype=np.uint64))


def np_sorted(records):
    return np.sort(records, order=("barcode", "umi", "index"))


def plain_file(path, records, sorted_flag=False, bc_len=16, umi_len=12):
    header = T.Header.new(bc_len, umi_len)
    if sorted_flag:
        header.set_sorted()
    with T.Writer.from_path(str(path), header) as w:
        if len(records):
            w.write_batch(records)
    return str(path)


def outcomes(call):
    """The result of ``call(native)`` under each library, an error as its
    class name and text."""
    out = {}
    for name, native in NATIVES.items():
        try:
            out[name] = ("ok", call(native, name))
        except Exception as e:  # noqa: BLE001 (the error is the result compared)
            out[name] = ("error", type(e).__name__, str(e))
    return out


@pytest.mark.parametrize("n,hi", [(0, 50), (1, 50), (3000, 50), (100_000, 1 << 60)])
def test_native_sort_records_matches(both_native, n, hi):
    rng = np.random.default_rng(2)
    recs = T.make_records(*[rng.integers(0, hi, n, dtype=np.uint64) for _ in range(3)])
    got = TN.sort_records(recs.copy())
    assert np.array_equal(got, JN.sort_records(recs.copy()))
    assert np.array_equal(got, np_sorted(recs))


def test_native_sort_records_in_place_or_a_copy(both_native, tmp_path):
    recs = T.make_records(np.array([3, 1, 2], np.uint64), np.zeros(3, np.uint64),
                          np.zeros(3, np.uint64))
    work = recs.copy()
    assert TN.sort_records(work) is work and work["barcode"].tolist() == [1, 2, 3]
    mm = T.MmapReader(plain_file(tmp_path / "ro.ibu", recs))
    out = TN.sort_records(mm.records)  # a read-only map: a sorted copy
    assert out["barcode"].tolist() == [1, 2, 3] and mm.records["barcode"].tolist() == [3, 1, 2]
    strided = T.make_records(np.array([5, 9, 3, 9, 1, 9], np.uint64), np.zeros(6, np.uint64),
                             np.zeros(6, np.uint64))[::2]
    assert TN.sort_records(strided)["barcode"].tolist() == [1, 3, 5]
    for native in NATIVES.values():
        with pytest.raises(ValueError, match="expected dtype"):
            native.sort_records(np.zeros(3, np.uint64))


GATHER_CASES = {
    "two reads": (b"@a\nACGTACGT\n+\nIIIIIIII\n@b\nTTTTACGT\n+\nIIIIIIII\n", 0, 8, None),
    "phase rides the global line": (b"@a\nACGTACGT\n+\nIIIIIIII\n@b\nTTTTACGT\n+\nIIIIIIII\n",
                                    2, 8, None),
    "crlf": (b"@a\r\nACGT\r\n+\r\nIIII\r\n", 0, 4, None),
    "short read": (b"@a\nAC\n+\nII\n", 100, 4, None),
    "short crlf read": (b"@a\nACGT\n+\nII\n@b\nACG\r\n+\nII\n", 0, 4, None),
    "start cap": (b"@a\nAAAA\n+\nIIII\n@b\nCCCC\n+\nIIII\n", 0, 4, 15),
    "cap at zero": (b"@a\nAAAA\n+\nIIII\n", 0, 4, 0),
    "partial last line": (b"@a\nAAAA\n+\nIIII\n@b\nCC", 0, 4, None),
    "no newline": (b"@a", 0, 4, None),
    "empty": (b"", 0, 4, None),
    "empty sibling lines": (b"@\nACGT\n+\n\n" * 5000, 0, 4, None),
    "only newlines": (b"\n" * 64, 0, 1, None),
}


@pytest.mark.parametrize("case", list(GATHER_CASES))
def test_native_fastq_gather_matches(both_native, case):
    data, first, prefix_len, cap = GATHER_CASES[case]
    got = TN.fastq_gather(data, first, prefix_len, cap)
    want = JN.fastq_gather(data, first, prefix_len, cap)
    assert got[0].dtype == want[0].dtype and np.array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    if case == "two reads":
        assert got[0].tolist() == [list(b"ACGTACGT"), list(b"TTTTACGT")]
        assert got[1:] == (len(data), 8, False, -1, 0)
    if case == "short read":
        assert got[4:] == (101, 2)
    if case == "start cap":
        assert got[0].tolist() == [list(b"AAAA")] and got[1:4] == (15, 4, True)
    if case == "empty sibling lines":
        assert got[0].shape == (5000, 4)  # the row bound holds with 1-byte siblings


def test_native_fastq_gather_accepts_any_buffer(both_native):
    data = b"@a\nACGT\n+\nIIII\n"
    for buf in (bytearray(data), memoryview(data), np.frombuffer(data, np.uint8)):
        assert TN.fastq_gather(buf, 0, 4)[0].tolist() == [list(b"ACGT")]


@pytest.mark.parametrize("n,chunk,nthreads", [(100_000, 10_000, 2), (100_000, 0, 0),
                                              (2_500_000, 0, 0), (1, 0, 1), (0, 0, 0)])
def test_native_sort_file_matches(both_native, tmp_path, n, chunk, nthreads):
    recs = keyed_records(n, 3)
    src = plain_file(tmp_path / "u.ibu", recs)
    outs = {}
    for name, native in NATIVES.items():
        outs[name] = str(tmp_path / f"{name}.ibu")
        native.sort_file(src, outs[name], chunk_records=chunk, nthreads=nthreads)
    with open(outs["torch"], "rb") as a, open(outs["jax"], "rb") as b:
        assert a.read() == b.read()
    r = T.MmapReader(outs["torch"])
    assert r.len() == n and r.header().sorted()
    assert np.array_equal(np.asarray(r.records), np_sorted(recs))
    assert not list(tmp_path.glob("*.run*"))  # the runs are cleaned up


def test_native_sort_file_errors_match(both_native, tmp_path):
    bad = tmp_path / "bad.ibu"
    bad.write_bytes(b"\x00" * 40)  # 32 header bytes and 8 ragged ones
    got = outcomes(lambda native, name: native.sort_file(str(bad), str(tmp_path / f"{name}.ibu")))
    assert got["torch"] == got["jax"] == (
        "error", "InvalidMapSize", "Invalid map size - not a multiple of record size")
    got = outcomes(lambda native, name: native.sort_file(str(tmp_path / "nope.ibu"),
                                                         str(tmp_path / f"{name}.ibu")))
    assert got["torch"] == got["jax"] and got["torch"][1] == "FileNotFoundError"
    assert [p.name for p in tmp_path.iterdir()] == ["bad.ibu"]


def write_runs(tmp_path, records, k):
    """``records`` dealt into ``k`` sorted headerless run files."""
    paths = []
    for i in range(k):
        paths.append(str(tmp_path / f"run{i}"))
        np_sorted(records[i::k]).tofile(paths[-1])
    return paths


def test_native_run_interval_matches(both_native, tmp_path):
    recs = np_sorted(T.make_records(np.repeat(np.arange(10, dtype=np.uint64), 100),
                                    np.zeros(1000, np.uint64), np.arange(1000, dtype=np.uint64)))
    run = str(tmp_path / "run0")
    recs.tofile(run)
    cases = {((3, 0, 0), (7, 0, 0)): (300, 700), ((0, 0, 0), None): (0, 1000),
             ((99, 0, 0), (200, 0, 0)): (1000, 1000), ((3, 0, 350), (3, 0, 360)): (350, 360),
             ((5, 1, 0), None): (600, 1000)}
    for (lo, hi), want in cases.items():
        assert TN.run_interval(run, lo, hi) == JN.run_interval(run, lo, hi) == want
    empty = str(tmp_path / "empty")
    open(empty, "wb").close()
    assert TN.run_interval(empty, (0, 0, 0)) == JN.run_interval(empty, (0, 0, 0)) == (0, 0)
    got = outcomes(lambda native, name: native.run_interval(run, (1, 2)))
    assert got["torch"] == got["jax"] and got["torch"][1] == "ValueError"
    ragged = tmp_path / "ragged"
    ragged.write_bytes(b"\0" * 25)
    got = outcomes(lambda native, name: native.run_interval(str(ragged), (0, 0, 0)))
    assert got["torch"] == got["jax"] and got["torch"][0] == "error"


@pytest.mark.parametrize("n,k,nthreads", [(50_000, 3, 0), (1_200_000, 4, 0), (1_200_000, 4, 1),
                                          (10, 2, 3), (0, 2, 0)])
def test_native_merge_runs_interval_matches(both_native, tmp_path, n, k, nthreads):
    recs = keyed_records(n, 5, hi=1 << 40)
    runs = write_runs(tmp_path, recs, k)
    outs = {}
    for name, native in NATIVES.items():
        outs[name] = str(tmp_path / f"{name}.ibu")
        header = T.Header.new(16, 12)
        header.set_sorted()
        with open(outs[name], "wb") as f:
            f.write(header.as_bytes())
            f.truncate(32 + 24 * n)
        native.merge_runs_interval(runs, (0, 0, 0), None, outs[name], 32, nthreads=nthreads,
                                   expect_records=n)
    with open(outs["torch"], "rb") as a, open(outs["jax"], "rb") as b:
        assert a.read() == b.read()
    assert np.array_equal(np.asarray(T.MmapReader(outs["torch"]).records), np_sorted(recs))


def test_native_merge_runs_interval_of_a_key_range(both_native, tmp_path):
    recs = keyed_records(30_000, 6, hi=1000)
    runs = write_runs(tmp_path, recs, 3)
    lo, hi = (200, 0, 0), (700, 0, 0)
    want = np_sorted(recs)
    want = want[(want["barcode"] >= 200) & (want["barcode"] < 700)]
    assert sum(b - a for a, b in (TN.run_interval(r, lo, hi) for r in runs)) == len(want)
    for name, native in NATIVES.items():
        out = str(tmp_path / f"{name}.bin")
        with open(out, "wb") as f:
            f.truncate(24 * len(want) + 7)
        native.merge_runs_interval(runs, lo, hi, out, 7, expect_records=len(want))
        assert np.array_equal(np.fromfile(out, dtype=T.RECORD_DTYPE, offset=7), want)


def test_native_merge_runs_interval_refuses_rather_than_writing_zeros(both_native, tmp_path):
    recs = keyed_records(100, 7)
    runs = write_runs(tmp_path, recs, 2)
    bad = np.zeros(3, dtype=T.RECORD_DTYPE)
    bad["barcode"] = [5, 3, 7]  # not sorted
    bad_run = str(tmp_path / "bad0")
    bad.tofile(bad_run)

    def merge(runs, expect):
        def call(native, name):
            out = str(tmp_path / f"{name}.ibu")
            with open(out, "wb") as f:
                f.truncate(32 + 24 * 100)
            native.merge_runs_interval(runs, (0, 0, 0), None, out, 32, expect_records=expect)
        return outcomes(call)

    wrong_total = merge(runs, 99)
    assert wrong_total["torch"] == wrong_total["jax"]
    assert wrong_total["torch"][1] == "OSError" and "merge_runs_interval failed" in wrong_total["torch"][2]
    unsorted = merge([bad_run], None)  # EILSEQ from the check inside the merge
    assert unsorted["torch"] == unsorted["jax"] and unsorted["torch"][1] == "OSError"
    missing = merge([str(tmp_path / "nope")], None)
    assert missing["torch"] == missing["jax"] and missing["torch"][1] == "FileNotFoundError"
    # no runs: nothing to do, in either library
    assert merge([], None)["torch"] == merge([], None)["jax"] == ("ok", None)


def test_native_merge_files_matches(both_native, tmp_path):
    rng = np.random.default_rng(70)
    parts, paths = [], []
    for k, n in enumerate((5000, 1, 70_000, 0)):  # 70,000 forces run refills
        recs = np_sorted(T.make_records(rng.integers(0, 1 << 40, n, dtype=np.uint64),
                                        rng.integers(0, 1 << 40, n, dtype=np.uint64),
                                        rng.integers(0, 1 << 63, n, dtype=np.uint64)))
        parts.append(recs)
        paths.append(plain_file(tmp_path / f"m{k}.ibu", recs, sorted_flag=True))
    outs = {}
    for name, native in NATIVES.items():
        outs[name] = str(tmp_path / f"{name}.ibu")
        native.merge_files(paths, outs[name])
    with open(outs["torch"], "rb") as a, open(outs["jax"], "rb") as b:
        assert a.read() == b.read()
    r = T.MmapReader(outs["torch"])
    assert r.header().sorted()
    assert np.array_equal(np.asarray(r.records), np_sorted(np.concatenate(parts)))


def test_native_merge_files_errors_match(both_native, tmp_path):
    seq = T.make_records(np.arange(10, dtype=np.uint64), np.zeros(10, np.uint64),
                         np.zeros(10, np.uint64))
    good = plain_file(tmp_path / "good.ibu", seq, sorted_flag=True)
    lying = plain_file(tmp_path / "lying.ibu", seq[::-1].copy(), sorted_flag=True)
    unflagged = plain_file(tmp_path / "u.ibu", seq)
    other = plain_file(tmp_path / "o8.ibu", seq, sorted_flag=True, bc_len=8, umi_len=8)

    def merge(paths, out=None):
        return outcomes(lambda native, name: native.merge_files(
            paths, out or str(tmp_path / f"{name}_out.ibu")))

    for paths, match in (([good, lying], "merge_files failed"), ([unflagged], "sorted flag not set"),
                         ([good, other], "differs from"), ([], "at least one input")):
        got = merge(paths)
        assert got["torch"] == got["jax"] and got["torch"][0] == "error"
        assert match in got["torch"][2]
        assert not list(tmp_path.glob("*_out.ibu"))
    got = merge([good], out=good)  # the output aliasing an input would truncate it
    assert got["torch"] == got["jax"] and "same file" in got["torch"][2]
    assert len(T.MmapReader(good)) == 10


def test_native_new_functions_need_the_library(monkeypatch):
    monkeypatch.setattr(TN, "_lib", None)
    monkeypatch.setattr(TN, "_load_error", "no g++")
    for call in (lambda: TN.sort_records(np.zeros(1, T.RECORD_DTYPE)),
                 lambda: TN.fastq_gather(b"", 0, 4), lambda: TN.sort_file("a", "b"),
                 lambda: TN.run_interval("a", (0, 0, 0)),
                 lambda: TN.merge_runs_interval(["a"], (0, 0, 0), None, "b", 0),
                 lambda: TN.merge_files(["a"], "b")):
        with pytest.raises(RuntimeError, match="native runtime unavailable: no g\\+\\+"):
            call()


# ---------------------------------------------------------------------------
# host helpers of the FASTQ slice
# ---------------------------------------------------------------------------


def test_header_dict_round_trip_matches():
    for flags, reserved in ((0, b"\0" * 8), (1, b"\x01\x02\x03\x04\x05\x06\x07\x08")):
        th = T.Header(bc_len=16, umi_len=12, flags=flags, reserved=reserved)
        jh = ibu_tpu.Header(bc_len=16, umi_len=12, flags=flags, reserved=reserved)
        assert th.to_dict() == jh.to_dict()
        assert T.Header.from_dict(jh.to_dict()).as_bytes() == jh.as_bytes()
        assert T.Header.from_dict(th.to_dict()) == th


def test_record_byte_helpers_match():
    from ibu_tpu.constructs import record as JR
    from ibu_tpu_torch.constructs import record as TR

    recs = random_records(257, 18)
    data = TR.records_to_bytes(recs)
    assert data == JR.records_to_bytes(recs) == recs.tobytes()
    assert TR.records_to_bytes(recs[::2]) == JR.records_to_bytes(recs[::2])
    for buf in (data, bytearray(data), memoryview(data)):
        back = TR.records_from_bytes(buf)
        assert back.dtype == TR.RECORD_DTYPE and np.array_equal(back, JR.records_from_bytes(buf))
        assert back.flags.writeable
    assert np.array_equal(TR.empty_records(5), JR.empty_records(5))
    assert TR.empty_records(0).dtype == TR.RECORD_DTYPE
    for module in (TR, JR):
        with pytest.raises(ValueError, match="byte length 25 is not a multiple of RECORD_SIZE=24"):
            module.records_from_bytes(b"\0" * 25)
        with pytest.raises(ValueError, match="expected dtype"):
            module.records_to_bytes(np.zeros(3, np.uint64))


def test_mmap_column_views_match(tmp_path):
    recs = random_records(100, 19)
    path = plain_file(tmp_path / "c.ibu", recs)
    t, j = T.MmapReader(path), ibu_tpu.MmapReader(path)
    for name, field in (("barcodes", "barcode"), ("umis", "umi"), ("indices", "index")):
        got = getattr(t, name)()
        assert got.dtype == np.uint64 and np.array_equal(got, getattr(j, name)())
        assert np.array_equal(got, recs[field]) and got.strides == (24,)


@pytest.mark.parametrize("n,shards", [(0, 1), (10, 3), (10_003, 4), (2, 5), (7, 7)])
def test_partition_matches(n, shards):
    from ibu_tpu.parallel.host import partition as j_partition
    from ibu_tpu_torch.parallel.host import partition

    got = partition(n, shards)
    assert got == j_partition(n, shards)
    assert got[0][0] == 0 and got[-1][1] == n and len(got) == shards


def test_partition_and_thread_count_errors_match():
    from ibu_tpu.parallel import host as JH
    from ibu_tpu_torch.parallel import host as TH

    for module in (TH, JH):
        with pytest.raises(ValueError, match="num_shards must be positive, got 0"):
            module.partition(5, 0)
        with pytest.raises(ValueError, match="num_threads must be >= 0, got -1"):
            module.resolve_num_threads(-1)
    for k in (0, 1, 2, 10_000):
        assert TH.resolve_num_threads(k) == JH.resolve_num_threads(k)


def test_as_buffered_wraps_a_decompression_chain(tmp_path):
    from ibu_tpu_torch.io.compression import as_buffered, open_decompressed

    plain, packed = tmp_path / "p.txt", tmp_path / "p.txt.gz"
    body = b"".join(b"line %d\n" % i for i in range(5000))
    plain.write_bytes(body)
    packed.write_bytes(gzip.compress(body))
    raw = open_decompressed(str(plain))
    assert as_buffered(raw) is raw  # already buffered
    raw.close()
    with as_buffered(open_decompressed(str(packed))) as f:
        assert isinstance(f, io.BufferedReader)
        assert f.read(7) == b"line 0\n" and f.read() == body[7:]
    assert f.closed


def test_compressed_writers_are_context_managers(tmp_path):
    from ibu_tpu_torch.io.compression import open_compressed

    path = str(tmp_path / "w.gz")
    with open_compressed(path) as out:
        out.write(b"abc")
    assert gzip.open(path).read() == b"abc"


def test_thread_prefetched_order_and_completeness():
    from ibu_tpu_torch.io.stream import thread_prefetched

    for depth in (0, 1, 3):
        assert list(thread_prefetched(iter(range(1000)), depth=depth)) == list(range(1000))
    assert list(thread_prefetched(iter(()))) == []


def test_thread_prefetched_producer_exception_reraises_in_consumer():
    from ibu_tpu_torch.io.stream import thread_prefetched

    def gen():
        yield 1
        yield 2
        raise RuntimeError("parse failed at line 9")

    it = thread_prefetched(gen(), depth=2)
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(RuntimeError, match="line 9"):
        next(it)


def test_thread_prefetched_runs_ahead_on_its_own_thread():
    import threading

    from ibu_tpu_torch.io.stream import thread_prefetched

    seen = []

    def gen():
        for i in range(4):
            seen.append(threading.current_thread().name)
            yield i

    assert list(thread_prefetched(gen(), depth=2)) == [0, 1, 2, 3]
    assert set(seen) == {"ibu-prefetch"}


def test_thread_prefetched_early_abandon_stops_producer():
    import threading
    import time

    from ibu_tpu_torch.io.stream import thread_prefetched

    produced = []

    def gen():
        for i in range(10_000):
            produced.append(i)
            yield i

    it = thread_prefetched(gen(), depth=2)
    for _, _ in zip(range(3), it):
        pass
    it.close()  # GeneratorExit -> stop event -> the producer drains out
    deadline = time.time() + 5
    while time.time() < deadline:
        alive = [t for t in threading.enumerate() if t.name == "ibu-prefetch"]
        if not alive:
            break
        time.sleep(0.05)
    assert not alive, "producer thread still running after close()"
    assert len(produced) < 10_000, "producer ran to completion anyway"
