"""The record pipeline as a whole, ``ibu_tpu_torch.pipelines`` against
``ibu_tpu.pipelines`` on the CPU: the same seeded inputs, exact equality of
records, rows and file bytes (tolerance 0)."""

import numpy as np
import pytest
import torch

from ibu_tpu import Header, MmapReader, Writer
from ibu_tpu import pipelines as JPL
from ibu_tpu.constructs.record import make_records
from ibu_tpu_torch import pipelines as TPL
from ibu_tpu_torch.ops import codec as TC
from tests.test_codec import random_rows
from tests.test_torch_cli import port_text

CPU = torch.device("cpu")


def inputs(n, bc_len=16, umi_len=12, seed=0):
    rng = np.random.default_rng(seed)
    bc = random_rows(n, bc_len, seed=seed + 1)
    umi = random_rows(n, umi_len, seed=seed + 2)
    idx = rng.integers(0, 1 << 64, size=n, dtype=np.uint64)
    return bc, umi, idx


@pytest.mark.parametrize("bc_len,umi_len", [(16, 12), (1, 32), (32, 17)])
@pytest.mark.parametrize("engine", ["device", "host"])
def test_encode_decode_batch_match_jax(bc_len, umi_len, engine):
    bc, umi, idx = inputs(611, bc_len, umi_len, seed=bc_len)
    records = TPL.encode_batch(bc, umi, idx, engine=engine, device=CPU)
    want = JPL.encode_batch(bc, umi, idx, engine="device")
    assert records.dtype == want.dtype and records.tobytes() == want.tobytes()
    got = TPL.decode_batch(records, bc_len, umi_len, engine=engine, device=CPU)
    for a, b, w in zip(got, JPL.decode_batch(records, bc_len, umi_len, engine="device"),
                       (bc, umi, idx)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert np.array_equal(a, w)


def test_engine_name_is_checked():
    bc, umi, idx = inputs(4)
    records = TPL.encode_batch(bc, umi, idx, engine="host")
    for call in (lambda: TPL.encode_batch(bc, umi, idx, engine="quantum", device=CPU),
                 lambda: TPL.decode_batch(records, 16, 12, engine="native", device=CPU)):
        with pytest.raises(ValueError, match="engine must be 'auto', 'device' or 'host', got"):
            call()
    # "auto" is an engine now, and the default, as in the JAX package
    assert TPL.encode_batch(bc, umi, idx, engine="auto", device=CPU).tobytes() == records.tobytes()


@pytest.mark.parametrize("hints", [{}, {"bc_len": 16, "umi_len": 12, "index_bits": 64}])
def test_sort_batch_matches_jax(hints):
    bc, umi, idx = inputs(700, seed=3)
    records = TPL.encode_batch(bc[:, :8].copy(), umi, idx, device=CPU)
    got = TPL.sort_batch(records, device=CPU, **hints)
    assert got.tobytes() == JPL.sort_batch(records, **hints).tobytes()


@pytest.mark.parametrize(
    "bc_len,umi_len,with_index", [(16, 12, False), (16, 12, True), (20, 10, False)]
)
def test_encode_sorted_file_byte_identical(tmp_path, bc_len, umi_len, with_index):
    n = 999
    bc, umi, idx = inputs(n, bc_len, umi_len, seed=9)
    # a few duplicate barcodes so the sort breaks ties on umi and index
    bc[::7] = bc[0]
    index = idx if with_index else None
    got_path, want_path = str(tmp_path / "t.ibu"), str(tmp_path / "j.ibu")
    header = TPL.encode_sorted_file(got_path, bc, umi, index, device=CPU)
    JPL.encode_sorted_file(want_path, bc, umi, index)
    with open(got_path, "rb") as g, open(want_path, "rb") as w:
        assert g.read() == w.read()
    assert header.sorted() and (header.bc_len, header.umi_len) == (bc_len, umi_len)


def test_encode_sorted_file_from_strings(tmp_path):
    seqs = ["TTTTACGTACGTACGT", "AAAAACGTACGTACGT", "CCCCACGTACGTACGT"]
    umis = ["ACGTACGTACGT", "TTTTACGTACGT", "GGGGACGTACGT"]
    got_path, want_path = str(tmp_path / "t.ibu"), str(tmp_path / "j.ibu")
    TPL.encode_sorted_file(got_path, seqs, umis, device=CPU)
    JPL.encode_sorted_file(want_path, seqs, umis)
    with open(got_path, "rb") as g, open(want_path, "rb") as w:
        assert g.read() == w.read()
    with pytest.raises(ValueError) as jax_err:
        JPL.encode_sorted_file(want_path, ["ACGN"], ["ACGT"])
    with pytest.raises(ValueError) as torch_err:
        TPL.encode_sorted_file(got_path, ["ACGN"], ["ACGT"], device=CPU)
    assert str(torch_err.value) == str(jax_err.value)


@pytest.mark.parametrize("as_strings", [False, True])
def test_decode_file_matches_jax(tmp_path, as_strings):
    bc, umi, idx = inputs(457, 17, 9, seed=4)
    path = str(tmp_path / "d.ibu")
    with Writer.from_path(path, Header.new(17, 9)) as w:
        w.write_batch(make_records(TC.np_pack(bc), TC.np_pack(umi), idx))
    got = TPL.decode_file(path, as_strings=as_strings, device=CPU)
    want = JPL.decode_file(path, as_strings=as_strings)
    assert got[0].as_bytes() == want[0].as_bytes()
    for a, b in zip(got[1:3], want[1:3]):
        assert a == b if as_strings else np.array_equal(a, b)
    assert np.array_equal(got[3], want[3])
    if not as_strings:
        assert np.array_equal(got[1], bc) and np.array_equal(got[3], idx)


@pytest.mark.parametrize("n", [0, 1, 2500])
def test_file_stats_matches_jax(tmp_path, n):
    rng = np.random.default_rng(n)
    cols = [rng.integers(0, 1 << 64, size=n, dtype=np.uint64) for _ in range(3)]
    path = str(tmp_path / "s.ibu")
    with Writer.from_path(path, Header.new(16, 12)) as w:
        w.write_batch(make_records(*cols))
    got = TPL.file_stats(path, engine="device", device=CPU)
    want = JPL.file_stats(path, engine="device")
    assert got == want
    assert TPL.file_stats(path, engine="native") == JPL.file_stats(path, engine="native")
    host = TPL.file_stats(path, engine="host")
    assert host == JPL.file_stats(path, engine="host")
    assert host == {**want, "engine": "host"}


@pytest.mark.parametrize("batch", [1, 7, 4 * 1024 * 1024])
def test_host_stats_match_jax(tmp_path, batch):
    rng = np.random.default_rng(batch)
    cols = [rng.integers(0, 1 << 64, size=50, dtype=np.uint64) for _ in range(3)]
    path = str(tmp_path / "h.ibu")
    with Writer.from_path(path, Header.new(16, 12)) as w:
        w.write_batch(make_records(*cols))
    from ibu_tpu_torch import MmapReader as TMmapReader

    got = TPL.host_file_stats(TMmapReader(path), batch_records=batch)
    assert got == JPL.host_file_stats(MmapReader(path), batch_records=batch)
    records = np.asarray(MmapReader(path).records)
    assert TPL.host_stream_stats([records[:20], records[20:]]) == JPL.host_stream_stats([records])


def test_file_stats_rejects_compressed_and_bad_engine(tmp_path):
    from tests.test_torch_stats import FIXTURES

    gz = str(FIXTURES / "one_record.ibu.gz")
    with pytest.raises(ValueError) as jax_err:
        JPL.file_stats(gz, engine="device")
    with pytest.raises(ValueError) as torch_err:
        TPL.file_stats(gz, engine="device", device=CPU)
    assert str(torch_err.value) == port_text(str(jax_err.value))
    plain = str(FIXTURES / "one_record.ibu")
    with pytest.raises(ValueError) as jax_err:
        JPL.file_stats(plain, engine="quantum")
    with pytest.raises(ValueError, match="engine must be auto/device/native/host, got 'quantum'") \
            as torch_err:
        TPL.file_stats(plain, engine="quantum", device=CPU)
    assert str(torch_err.value) == str(jax_err.value)
    # "auto" is an engine now, and the default, as in the JAX package
    assert TPL.file_stats(plain, engine="auto", device=CPU)["count"] == 1


def test_slice_as_a_whole(tmp_path):
    """encode → sort → file → decode and stream stats, port against JAX."""
    bc, umi, idx = inputs(1234, seed=12)
    t_path, j_path = str(tmp_path / "t.ibu"), str(tmp_path / "j.ibu")
    TPL.encode_sorted_file(t_path, bc, umi, idx, device=CPU)
    JPL.encode_sorted_file(j_path, bc, umi, idx)
    t_dec = TPL.decode_file(t_path, device=CPU)
    j_dec = JPL.decode_file(j_path)
    for a, b in zip(t_dec[1:], j_dec[1:]):
        assert np.array_equal(a, b)
    assert TPL.file_stats(t_path, engine="device", device=CPU) == JPL.file_stats(
        j_path, engine="device")
    order = np.lexsort((idx, TC.np_pack(umi), TC.np_pack(bc)))
    assert np.array_equal(t_dec[3], idx[order])
    assert MmapReader(t_path).len() == 1234
