"""The device file sort, UMI deduplication and the count matrix, the port
(``ibu_tpu_torch.pipelines``) against the JAX package (``ibu_tpu.pipelines``)
on the CPU.

The cases mirror the reference's own (``tests/test_dedup.py``,
``tests/test_count.py``) on the same seeded inputs. Tolerance 0: output files
are compared byte for byte, statistics dicts and error texts for equality.
The port's device calls run their torch code on the CPU (``device="cpu"``).
"""

from pathlib import Path

import numpy as np
import pytest

from ibu_tpu import Header, MmapReader, Writer
from ibu_tpu import pipelines as JPL
from ibu_tpu.constructs.record import make_records
from ibu_tpu_torch import pipelines as TPL

CPU = "cpu"
U64_MAX = (1 << 64) - 1


def write(path, bc, umi, idx, bc_len=8, umi_len=6, sorted_flag=False, compression=None):
    recs = make_records(
        np.asarray(bc, np.uint64), np.asarray(umi, np.uint64), np.asarray(idx, np.uint64)
    )
    header = Header.new(bc_len, umi_len)
    if sorted_flag:
        header.set_sorted()
    kwargs = {} if compression is None else {"compression": compression}
    with Writer.from_path(str(path), header, **kwargs) as w:
        w.write_batch(recs)
    return str(path)


def sorted_copy(path, out):
    recs = np.asarray(MmapReader(path).records)
    order = np.lexsort((recs["index"], recs["umi"], recs["barcode"]))
    header = MmapReader(path).header()
    header.set_sorted()
    with Writer.from_path(str(out), header) as w:
        w.write_batch(recs[order])
    return str(out)


def same_error(jax_call, torch_call, exc=ValueError):
    with pytest.raises(exc) as jax_err:
        jax_call()
    with pytest.raises(exc) as torch_err:
        torch_call()
    assert str(torch_err.value) == str(jax_err.value)
    return str(torch_err.value)


def trio(prefix):
    return tuple(Path(f"{prefix}{ext}").read_bytes()
                 for ext in (".mtx", ".barcodes.txt", ".indices.txt"))


def random_file(tmp_path, name, seed, n, n_bc, n_umi, n_idx, **kw):
    rng = np.random.default_rng(seed)
    return write(tmp_path / name, rng.integers(0, n_bc, n), rng.integers(0, n_umi, n),
                 rng.integers(0, n_idx, n), **kw)


# ---------------------------------------------------------------------------
# sort_file_device
# ---------------------------------------------------------------------------

SORT_CASES = {
    "bc8/umi6 small index": dict(bits=(16, 12, 20), lens=(8, 6)),
    "bc16/umi12 full index": dict(bits=(32, 24, 64), lens=(16, 12)),
    "bc32/umi32 full range": dict(bits=(64, 64, 64), lens=(32, 32)),
}


@pytest.mark.parametrize("case", list(SORT_CASES))
@pytest.mark.parametrize("index_bits", [None, 64])
def test_sort_file_device_byte_identical(tmp_path, case, index_bits):
    spec = SORT_CASES[case]
    rng = np.random.default_rng(len(case))
    n = 3001
    cols = [rng.integers(0, 1 << b, n, dtype=np.uint64) if b < 64
            else rng.integers(0, 1 << 64, n, dtype=np.uint64) for b in spec["bits"]]
    cols[0][::5] = cols[0][0]  # ties on the barcode
    cols[1][::10] = cols[1][0]  # and on barcode + umi
    src = write(tmp_path / "in.ibu", *cols, *spec["lens"])
    got, want = tmp_path / "t.ibu", tmp_path / "j.ibu"
    header = TPL.sort_file_device(src, str(got), index_bits=index_bits, device=CPU)
    JPL.sort_file_device(src, str(want), index_bits=index_bits)
    assert got.read_bytes() == want.read_bytes()
    assert header.sorted() and header.as_bytes() == MmapReader(str(got)).header().as_bytes()


def test_sort_file_device_keeps_flags_and_empty(tmp_path):
    src = write(tmp_path / "e.ibu", [], [], [], sorted_flag=True)
    got, want = tmp_path / "t.ibu", tmp_path / "j.ibu"
    TPL.sort_file_device(src, str(got), device=CPU)
    JPL.sort_file_device(src, str(want))
    assert got.read_bytes() == want.read_bytes()


def test_sort_file_device_violated_hint_and_compressed(tmp_path):
    # a 16-base header whose barcodes use the hi word violates the hint
    src = write(tmp_path / "bad.ibu", [1 << 40, 3], [1, 2], [0, 1], bc_len=16, umi_len=12)
    text = same_error(lambda: JPL.sort_file_device(src, str(tmp_path / "j.ibu")),
                      lambda: TPL.sort_file_device(src, str(tmp_path / "t.ibu"), device=CPU))
    assert "sort hint violated: barcode" in text
    gz = write(tmp_path / "z.ibu.gz", [1], [1], [1], compression="gzip")
    same_error(lambda: JPL.sort_file_device(gz, str(tmp_path / "j.ibu")),
               lambda: TPL.sort_file_device(gz, str(tmp_path / "t.ibu"), device=CPU))


# ---------------------------------------------------------------------------
# dedup_file
# ---------------------------------------------------------------------------


def dup_file(tmp_path, name, seed, n, sorted_flag):
    rng = np.random.default_rng(seed)
    bc = rng.integers(0, 17, n)
    umi = rng.integers(0, 11, n)
    path = write(tmp_path / f"raw_{name}", bc, umi, np.arange(n), 16, 12)
    if sorted_flag:
        return sorted_copy(path, tmp_path / name)
    return path


@pytest.mark.parametrize(
    "sorted_flag,assume_sorted,batch",
    [(True, None, 97), (True, None, 4 * 1024 * 1024), (False, None, 97),
     (False, None, 4 * 1024 * 1024), (True, False, 500), (False, True, 300)],
)
def test_dedup_file_matches_jax(tmp_path, sorted_flag, assume_sorted, batch):
    src = dup_file(tmp_path, "in.ibu", 2 + batch % 7, 5000, sorted_flag)
    if assume_sorted:
        # an unset flag trusted on a sorted file
        src = write(tmp_path / "trusted.ibu", *(np.asarray(MmapReader(sorted_copy(
            src, tmp_path / "s.ibu")).records)[f] for f in ("barcode", "umi", "index")), 16, 12)
    got, want = tmp_path / "t.ibu", tmp_path / "j.ibu"
    t_stats = TPL.dedup_file(src, str(got), batch_records=batch,
                             assume_sorted=assume_sorted, device=CPU)
    j_stats = JPL.dedup_file(src, str(want), batch_records=batch, assume_sorted=assume_sorted)
    assert t_stats == j_stats
    assert got.read_bytes() == want.read_bytes()
    assert MmapReader(str(got)).header().sorted()
    # no temporary sort file is left beside the output
    assert sorted(p.name for p in tmp_path.iterdir() if p.name.startswith("tmp")) == []


def test_dedup_file_is_idempotent(tmp_path):
    src = dup_file(tmp_path, "in.ibu", 8, 4000, sorted_flag=False)
    once, twice = tmp_path / "once.ibu", tmp_path / "twice.ibu"
    first = TPL.dedup_file(src, str(once), device=CPU)
    second = TPL.dedup_file(str(once), str(twice), batch_records=77, device=CPU)
    assert once.read_bytes() == twice.read_bytes()
    assert second == {"records": first["molecules"], "molecules": first["molecules"],
                      "barcodes": first["barcodes"]}


def test_dedup_file_lying_flag_empty_and_compressed(tmp_path):
    bc = np.array([5, 1], dtype=np.uint64)
    lie = write(tmp_path / "lie.ibu", bc, bc, bc, 16, 12, sorted_flag=True)
    text = same_error(lambda: JPL.dedup_file(lie, str(tmp_path / "j.ibu")),
                      lambda: TPL.dedup_file(lie, str(tmp_path / "t.ibu"), device=CPU))
    assert "not in sorted order" in text
    assert not (tmp_path / "t.ibu").exists() and not (tmp_path / "j.ibu").exists()

    empty = write(tmp_path / "e.ibu", [], [], [], 16, 12, sorted_flag=True)
    assert TPL.dedup_file(empty, str(tmp_path / "et.ibu"), device=CPU) == \
        JPL.dedup_file(empty, str(tmp_path / "ej.ibu"))
    assert (tmp_path / "et.ibu").read_bytes() == (tmp_path / "ej.ibu").read_bytes()

    gz = write(tmp_path / "z.ibu.gz", [1], [1], [1], compression="gzip")
    same_error(lambda: JPL.dedup_file(gz, str(tmp_path / "j.ibu")),
               lambda: TPL.dedup_file(gz, str(tmp_path / "t.ibu"), device=CPU))


# ---------------------------------------------------------------------------
# count_matrix
# ---------------------------------------------------------------------------


def count_both(tmp_path, src, torch_kw=None, **kw):
    """The port's and the reference's trio and dicts on one input path (the
    ``.mtx`` names its source, so both read the same file)."""
    t_stats = TPL.count_matrix(src, str(tmp_path / "t"), **kw, **(torch_kw or {}))
    j_stats = JPL.count_matrix(src, str(tmp_path / "j"), **kw)
    assert t_stats == j_stats
    assert trio(tmp_path / "t") == trio(tmp_path / "j")
    return t_stats


@pytest.mark.parametrize("engine", ["host", "device"])
def test_known_duplicate_structure(tmp_path, engine):
    src = write(tmp_path / "a.ibu", bc=[1, 1, 1, 1, 2, 2, 2], umi=[1, 1, 2, 1, 9, 9, 9],
                idx=[10, 10, 10, 11, 10, 10, 10], sorted_flag=True)
    src = sorted_copy(src, tmp_path / "as.ibu")
    stats = count_both(tmp_path, src, torch_kw={"device": CPU}, engine=engine)
    assert stats == {"barcodes": 2, "indices": 2, "entries": 3, "molecules": 4, "records": 7}


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("sorted_flag", [False, True])
def test_host_engine_matches_jax(tmp_path, dedup, sorted_flag):
    src = random_file(tmp_path, "r.ibu", 5, 5000, 40, 8, 25)
    if sorted_flag:
        src = sorted_copy(src, tmp_path / "rs.ibu")
    count_both(tmp_path, src, batch_records=700, dedup=dedup)


def test_host_engine_lying_flag(tmp_path):
    lie = write(tmp_path / "liar.ibu", [5, 1], [0, 0], [0, 0], sorted_flag=True)
    text = same_error(lambda: JPL.count_matrix(lie, str(tmp_path / "j")),
                      lambda: TPL.count_matrix(lie, str(tmp_path / "t")))
    assert "out of order" in text


@pytest.mark.parametrize("batch", [700, 4 * 1024 * 1024])
def test_device_engine_matches_jax_device_engine(tmp_path, batch):
    src = sorted_copy(random_file(tmp_path, "d.ibu", 11, 6000, 30, 7, 15), tmp_path / "ds.ibu")
    t = TPL.count_matrix(src, str(tmp_path / "t"), batch_records=batch, engine="device",
                         max_pairs=1024, device=CPU)
    j = JPL.count_matrix(src, str(tmp_path / "j"), batch_records=batch, engine="device",
                         max_pairs=1024)
    h = TPL.count_matrix(src, str(tmp_path / "h"), batch_records=batch)
    assert t == j == h
    assert trio(tmp_path / "t") == trio(tmp_path / "j") == trio(tmp_path / "h")


def test_device_engine_capacity_growth(tmp_path):
    # > 16384 distinct pairs: the table grows past its 2^14 start mid-stream
    rng = np.random.default_rng(29)
    n = 30_000
    src = write(tmp_path / "g.ibu", bc=np.sort(rng.integers(0, 220, n)),
                umi=rng.integers(0, 5, n), idx=rng.integers(0, 120, n))
    src = sorted_copy(src, tmp_path / "gs.ibu")
    stats = count_both(tmp_path, src, torch_kw={"engine": "device", "device": CPU})
    assert stats["entries"] > 16384


@pytest.mark.parametrize("batch", [2, 3, 6])
def test_device_engine_boundary_duplicate_triple(tmp_path, batch):
    src = write(tmp_path / "b.ibu", bc=[1] * 6, umi=[2] * 6, idx=[3] * 6)
    t = TPL.count_matrix(src, str(tmp_path / "t"), batch_records=batch, engine="device",
                         max_pairs=64, device=CPU)
    JPL.count_matrix(src, str(tmp_path / "j"), batch_records=batch)
    assert t["entries"] == 1 and t["molecules"] == 1
    assert trio(tmp_path / "t") == trio(tmp_path / "j")


def test_device_engine_u64_max_fields(tmp_path):
    src = write(tmp_path / "m.ibu", bc=[5, U64_MAX, U64_MAX], umi=[1, U64_MAX, U64_MAX],
                idx=[2, U64_MAX, U64_MAX], bc_len=32, umi_len=32)
    stats = count_both(tmp_path, src, torch_kw={"device": CPU}, engine="device", max_pairs=64)
    assert stats["entries"] == 2 and stats["molecules"] == 2
    # bit 63 in every field and an order that needs the sign flip
    rng = np.random.default_rng(3)
    cols = [rng.integers(0, 1 << 64, 400, dtype=np.uint64) for _ in range(3)]
    cols[0][::2] = np.uint64(U64_MAX - 1)
    src = sorted_copy(write(tmp_path / "w.ibu", *cols, 32, 32), tmp_path / "ws.ibu")
    t = TPL.count_matrix(src, str(tmp_path / "wt"), batch_records=64, engine="device",
                         max_pairs=1 << 10, device=CPU)
    assert t == JPL.count_matrix(src, str(tmp_path / "wj"))
    assert trio(tmp_path / "wt") == trio(tmp_path / "wj")


def test_device_engine_refusals(tmp_path):
    unsorted = write(tmp_path / "u.ibu", bc=[5, 1], umi=[0, 0], idx=[0, 0])
    text = same_error(
        lambda: JPL.count_matrix(unsorted, str(tmp_path / "j"), engine="device"),
        lambda: TPL.count_matrix(unsorted, str(tmp_path / "t"), engine="device", device=CPU))
    assert "sorted input" in text
    src = write(tmp_path / "x.ibu", bc=list(range(20)), umi=[0] * 20, idx=[0] * 20)
    text = same_error(
        lambda: JPL.count_matrix(src, str(tmp_path / "j"), engine="device", dedup=False),
        lambda: TPL.count_matrix(src, str(tmp_path / "t"), engine="device", dedup=False))
    assert "dedup semantics" in text
    text = same_error(
        lambda: JPL.count_matrix(src, str(tmp_path / "j"), engine="device", max_pairs=8),
        lambda: TPL.count_matrix(src, str(tmp_path / "t"), engine="device", max_pairs=8,
                                 device=CPU))
    assert "max_pairs=8" in text
    same_error(lambda: JPL.count_matrix(src, str(tmp_path / "j"), engine="auto"),
               lambda: TPL.count_matrix(src, str(tmp_path / "t"), engine="auto"))


@pytest.mark.parametrize("engine", ["host", "device"])
def test_empty_file(tmp_path, engine):
    src = write(tmp_path / "e.ibu", bc=[], umi=[], idx=[])
    stats = count_both(tmp_path, src, torch_kw={"device": CPU} if engine == "device" else {},
                       engine=engine)
    assert stats == {"barcodes": 0, "indices": 0, "entries": 0, "molecules": 0, "records": 0}


def test_compressed_input_clear_error(tmp_path):
    gz = write(tmp_path / "z.ibu.gz", np.arange(5), np.zeros(5), np.zeros(5), compression="auto")
    text = same_error(lambda: JPL.count_matrix(gz, str(tmp_path / "j")),
                      lambda: TPL.count_matrix(gz, str(tmp_path / "t")))
    assert "gzip-compressed" in text


def test_dedup_then_count_as_a_whole(tmp_path):
    """sort → dedup → count on both packages: every file and dict equal."""
    src = random_file(tmp_path, "x.ibu", 9, 3000, 20, 6, 10)
    for pkg, kw in ((TPL, {"device": CPU}), (JPL, {})):
        tag = "t" if pkg is TPL else "j"
        pkg.sort_file_device(src, str(tmp_path / f"{tag}_sorted.ibu"), **kw)
        pkg.dedup_file(src, str(tmp_path / f"{tag}_dd.ibu"), assume_sorted=False, **kw)
        pkg.count_matrix(str(tmp_path / f"{tag}_dd.ibu"), str(tmp_path / f"{tag}_m"))
    for name in ("sorted.ibu", "dd.ibu", "m.barcodes.txt", "m.indices.txt"):
        assert (tmp_path / f"t_{name}").read_bytes() == (tmp_path / f"j_{name}").read_bytes()
    t_mtx = (tmp_path / "t_m.mtx").read_bytes().split(b"\n")
    j_mtx = (tmp_path / "j_m.mtx").read_bytes().split(b"\n")
    assert t_mtx[0] == j_mtx[0] and t_mtx[2:] == j_mtx[2:]  # line 1 names the source
