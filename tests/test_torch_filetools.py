"""The host file tools of ``ibu_tpu_torch.pipelines`` (``filter_file``,
``lookup_barcodes``, ``split_file``, ``check_file``, ``concat_files``,
``repair_file``, ``subsample_file``) against ``ibu_tpu.pipelines`` on the same
seeded inputs.

Tolerance: none. Both packages read the same input files; output files are
compared byte for byte, dicts and arrays for equality, and a raised error by
its class name and its text, character for character.
"""

import gzip

import numpy as np
import pytest

from ibu_tpu import Header, Writer
from ibu_tpu import pipelines as JPL
from ibu_tpu.constructs.record import make_records
from ibu_tpu_torch import pipelines as TPL
from tests.test_torch_cli import port_text

HAVE_ZSTD = True
try:
    import zstandard  # noqa: F401
except ImportError:  # pragma: no cover
    HAVE_ZSTD = False


def write(path, records, bc_len=8, umi_len=6, sorted_flag=False, compression=None):
    h = Header.new(bc_len, umi_len)
    if sorted_flag:
        h.set_sorted()
    with Writer.from_path(str(path), h, compression=compression) as w:
        if len(records):
            w.write_batch(records)
    return str(path)


def sorted_records(lo, hi):
    bc = np.arange(lo, hi, dtype=np.uint64)
    return make_records(bc, bc % np.uint64(7), np.arange(hi - lo, dtype=np.uint64))


def random_records(n, seed, bc_hi=60):
    rng = np.random.default_rng(seed)
    return make_records(
        rng.integers(0, bc_hi, n).astype(np.uint64),
        rng.integers(0, 1 << 20, n).astype(np.uint64),
        np.arange(n, dtype=np.uint64),
    )


def outcome(fn, *args, **kwargs):
    """``("ok", value)`` or ``("error", class name, text)``."""
    try:
        return ("ok", fn(*args, **kwargs))
    except Exception as e:  # noqa: BLE001 (the error is the result compared)
        return ("error", type(e).__name__, str(e))


def both(name, tmp_path, in_args, out_name=None, **kwargs):
    """Call ``name`` of both packages on the same inputs; with ``out_name``
    each writes its own output file, given after the inputs. Returns the two
    outcomes and the two output paths."""
    outs = []
    results = []
    for tag, module in (("j", JPL), ("t", TPL)):
        args = list(in_args)
        out = None
        if out_name is not None:
            out = str(tmp_path / f"{tag}_{out_name}")
            args.insert(1, out)
        outs.append(out)
        results.append(outcome(getattr(module, name), *args, **kwargs))
    return results[0], results[1], outs[0], outs[1]


def same(j, t):
    assert t[0] == j[0], (j, t)
    if j[0] == "ok" and isinstance(j[1], np.ndarray):
        assert t[1].dtype == j[1].dtype and np.array_equal(t[1], j[1])
    elif j[0] == "error":  # the texts name each package's own command
        assert t == (*j[:2], port_text(j[2]))
    else:
        assert t == j


def same_files(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


# -- filter -----------------------------------------------------------------

FILTER_CASES = {
    "allowlist in order": (random_records(10_000, 0, 50), [3, 17, 42],
                           {"batch_records": 333}, False),
    "invert": (random_records(500, 1, 5), [2], {"invert": True}, False),
    "sorted flag and u64 extremes": (
        make_records(np.array([0, 5, 0xFFFFFFFFFFFFFFFF], np.uint64),
                     np.arange(3, dtype=np.uint64), np.arange(3, dtype=np.uint64)),
        [0, 0xFFFFFFFFFFFFFFFF], {}, True),
    "empty allowlist": (random_records(30, 2), [], {}, False),
    "empty allowlist inverted": (random_records(30, 2), [], {"invert": True}, False),
    "numpy allowlist with repeats": (random_records(3000, 3), np.array([7, 7, 9, 59], np.uint64),
                                     {"batch_records": 1000}, True),
    "empty file": (random_records(0, 4), [1], {}, True),
}


@pytest.mark.parametrize("case", list(FILTER_CASES))
def test_filter_file_matches_jax(tmp_path, case):
    records, allow, kwargs, flag = FILTER_CASES[case]
    src = write(tmp_path / "in.ibu", records, 16, 12, sorted_flag=flag)
    j, t, jo, to = both("filter_file", tmp_path, [src, allow], "out.ibu", **kwargs)
    same(j, t)
    assert j[0] == "ok"
    same_files(jo, to)


def test_filter_file_refuses_compressed_like_jax(tmp_path):
    src = write(tmp_path / "in.ibu.gz", random_records(10, 5), compression="auto")
    j, t, _, _ = both("filter_file", tmp_path, [src, [1]], "out.ibu")
    assert j[0] == "error" and "filter_file needs random access" in j[2]
    same(j, t)


@pytest.mark.parametrize("invert", [False, True])
def test_allowlist_mask_matches_jax(invert):
    rng = np.random.default_rng(6)
    bc = rng.integers(0, 100, 5000).astype(np.uint64)
    for allow in (np.array([], np.uint64), np.array([99], np.uint64),
                  np.unique(rng.integers(0, 120, 40).astype(np.uint64))):
        got = TPL.allowlist_mask(bc, allow, invert)
        assert np.array_equal(got, JPL.allowlist_mask(bc, allow, invert))
        assert np.array_equal(got, np.isin(bc, allow) ^ invert)


# -- lookup -----------------------------------------------------------------


def sorted_file(tmp_path, records, name="s.ibu"):
    return write(tmp_path / name, np.sort(records, order=("barcode", "umi", "index")),
                 16, 12, sorted_flag=True)


def test_lookup_constants_match():
    assert TPL.LOOKUP_BATCH_MIN == JPL.LOOKUP_BATCH_MIN


LOOKUP_CASES = {
    "bisect regime": (random_records(20_000, 3), [7, 13, 59, 1000]),
    "duplicate queries": (random_records(50, 4, 3), [2, 2, 2]),
    "first, last and u64 max": (
        make_records(np.array([0, 1, 2, 0xFFFFFFFFFFFFFFFF], np.uint64),
                     np.zeros(4, np.uint64), np.arange(4, dtype=np.uint64)),
        [0, 0xFFFFFFFFFFFFFFFF]),
    "absent": (random_records(30, 5, 3), [42]),
    "empty file": (random_records(0, 6), [1]),
    "batch regime": (random_records(50_000, 11, 2000),
                     np.unique(np.random.default_rng(12).integers(0, 3000, 600)).astype(np.uint64)),
    "batch regime all absent": (random_records(3, 7, 3),
                                np.arange(1000, 1000 + 256, dtype=np.uint64)),
    "generator of queries": (random_records(400, 8, 9), range(3, 6)),
}


@pytest.mark.parametrize("case", list(LOOKUP_CASES))
def test_lookup_barcodes_matches_jax(tmp_path, case):
    records, queries = LOOKUP_CASES[case]
    path = sorted_file(tmp_path, records)
    if isinstance(queries, range):
        j = outcome(JPL.lookup_barcodes, path, iter(queries))
        t = outcome(TPL.lookup_barcodes, path, iter(queries))
    else:
        j, t, _, _ = both("lookup_barcodes", tmp_path, [path, queries])
    assert j[0] == "ok"
    same(j, t)
    want = np.sort(records, order=("barcode", "umi", "index"))
    want = want[np.isin(want["barcode"], np.asarray(list(queries), dtype=np.uint64))]
    assert np.array_equal(t[1], want)


def test_lookup_without_the_flag_raises_like_jax(tmp_path):
    path = write(tmp_path / "u.ibu", random_records(9, 9), 16, 12)
    j, t, _, _ = both("lookup_barcodes", tmp_path, [path, [1]])
    assert j[0] == "error" and "lookup needs the sorted flag" in j[2]
    same(j, t)


# -- split ------------------------------------------------------------------


@pytest.mark.parametrize("n,shards", [(10_003, 4), (2, 5), (0, 3), (7, 1)])
def test_split_file_matches_jax(tmp_path, n, shards):
    src = sorted_file(tmp_path, random_records(n, 80, 1 << 20), "whole.ibu")
    jp = JPL.split_file(src, str(tmp_path / "j{}.ibu"), shards)
    tp = TPL.split_file(src, str(tmp_path / "t{}.ibu"), shards)
    assert len(jp) == len(tp) == shards
    for a, b in zip(jp, tp):
        same_files(a, b)


@pytest.mark.parametrize("template,shards", [("same.ibu", 2), ("s{}.ibu", 0)])
def test_split_file_errors_match_jax(tmp_path, template, shards):
    src = sorted_file(tmp_path, random_records(5, 81))
    j = outcome(JPL.split_file, src, str(tmp_path / template), shards)
    t = outcome(TPL.split_file, src, str(tmp_path / template), shards)
    assert j[0] == "error"
    same(j, t)


def test_split_file_refuses_compressed_like_jax(tmp_path):
    src = write(tmp_path / "in.ibu.gz", random_records(10, 5), compression="auto")
    j = outcome(JPL.split_file, src, str(tmp_path / "s{}.ibu"), 2)
    t = outcome(TPL.split_file, src, str(tmp_path / "s{}.ibu"), 2)
    assert j[0] == "error" and "split needs random access" in j[2]
    same(j, t)


def test_split_then_merge_files_round_trips(tmp_path):
    from ibu_tpu_torch import native

    if not native.available():
        pytest.skip("native runtime unavailable")
    src = sorted_file(tmp_path, random_records(10_003, 82, 1 << 20), "whole.ibu")
    shards = TPL.split_file(src, str(tmp_path / "sh{}.ibu"), 4)
    merged = str(tmp_path / "merged.ibu")
    native.merge_files(shards, merged)
    same_files(merged, src)


# -- check ------------------------------------------------------------------


def corrupt(path, fn):
    with open(path, "rb") as f:
        raw = bytearray(f.read())
    with open(path, "wb") as f:
        f.write(bytes(fn(raw)))
    return path


def flip(at, mask=0xFF):
    def fn(raw):
        raw[at if at >= 0 else len(raw) // 2] ^= mask
        return raw
    return fn


def regress(records, at):
    out = records.copy()
    out["barcode"][at] = 0
    return out


CHECK_CASES = {
    "clean sorted": lambda d: write(d / "a.ibu", sorted_records(0, 1000), sorted_flag=True),
    "empty": lambda d: write(d / "e.ibu", sorted_records(0, 0)),
    "bad magic": lambda d: corrupt(write(d / "m.ibu", sorted_records(0, 4)), flip(0)),
    "bad version": lambda d: corrupt(write(d / "v.ibu", sorted_records(0, 4)), flip(4)),
    "truncated tail": lambda d: corrupt(write(d / "t.ibu", sorted_records(0, 10)),
                                        lambda raw: raw[:-5]),
    "too short for a header": lambda d: corrupt(write(d / "h.ibu", sorted_records(0, 1)),
                                                lambda raw: raw[:7]),
    "lying sorted flag": lambda d: write(d / "l.ibu", sorted_records(0, 100)[::-1].copy(),
                                         sorted_flag=True),
    "out of range fields": lambda d: write(
        d / "r.ibu", make_records(np.array([3, 200], np.uint64), np.array([1, 99], np.uint64),
                                  np.array([0, 1], np.uint64)), bc_len=2, umi_len=2),
    "width 32 fields": lambda d: write(
        d / "w.ibu", make_records(*[np.array([0xFFFFFFFFFFFFFFFF], np.uint64)] * 3),
        bc_len=32, umi_len=32),
    "gzip": lambda d: write(d / "g.ibu.gz", sorted_records(0, 50), sorted_flag=True,
                            compression="auto"),
    "torn gzip": lambda d: corrupt(
        write(d / "tg.ibu.gz", sorted_records(0, 5000), sorted_flag=True, compression="auto"),
        lambda raw: raw[: len(raw) // 2]),
    "corrupt gzip": lambda d: corrupt(
        write(d / "cg.ibu.gz", sorted_records(0, 5000), sorted_flag=True, compression="auto"),
        flip(-1)),
    "missing file": lambda d: str(d / "nope.ibu"),
}
ZSTD_CHECK_CASES = {
    "zstd": lambda d: write(d / "z.ibu.zst", sorted_records(0, 50), sorted_flag=True,
                            compression="auto"),
    "torn zstd": lambda d: corrupt(
        write(d / "tz.ibu.zst", sorted_records(0, 5000), sorted_flag=True, compression="auto"),
        lambda raw: raw[: len(raw) // 2]),
    "bit-flipped zstd": lambda d: corrupt(
        write(d / "fz.ibu.zst", sorted_records(0, 5000), sorted_flag=True, compression="auto"),
        flip(-1, 0x10)),
}


@pytest.mark.parametrize("case", list(CHECK_CASES) + list(ZSTD_CHECK_CASES))
def test_check_file_report_matches_jax(tmp_path, case):
    if case in ZSTD_CHECK_CASES and not HAVE_ZSTD:
        pytest.skip("zstandard not installed")
    path = {**CHECK_CASES, **ZSTD_CHECK_CASES}[case](tmp_path)
    j, t, _, _ = both("check_file", tmp_path, [path])
    same(j, t)
    if case == "truncated tail":
        assert t[1]["records"] == 9 and not t[1]["ok"]
    if case == "clean sorted":
        assert t[1]["ok"] and t[1]["header"]["bc_len"] == 8


def test_check_file_order_violation_across_batches_matches_jax(tmp_path):
    recs = sorted_records(0, 64)
    good = write(tmp_path / "x.ibu", recs, sorted_flag=True)
    bad = write(tmp_path / "x2.ibu", regress(recs, 32), sorted_flag=True)
    for path, violation in ((good, None), (bad, 32)):
        j, t, _, _ = both("check_file", tmp_path, [path], buffer_records=32)
        same(j, t)
        assert t[1]["first_order_violation"] == violation


# -- concat -----------------------------------------------------------------


def interior_dip(lo, hi):
    recs = sorted_records(lo, hi)
    recs["barcode"][(hi - lo) // 2] = lo
    return recs


CONCAT_CASES = {
    "sorted shards stay sorted": lambda d: (
        [write(d / "a.ibu", sorted_records(0, 100), sorted_flag=True),
         write(d / "b.ibu", sorted_records(100, 250), sorted_flag=True)], "out.ibu"),
    "overlap clears the flag": lambda d: (
        [write(d / "a.ibu", sorted_records(0, 100), sorted_flag=True),
         write(d / "b.ibu", sorted_records(50, 150), sorted_flag=True)], "out.ibu"),
    "unsorted input clears the flag": lambda d: (
        [write(d / "a.ibu", sorted_records(0, 10), sorted_flag=True),
         write(d / "b.ibu", sorted_records(10, 20))], "out.ibu"),
    "empty input in the chain": lambda d: (
        [write(d / "a.ibu", sorted_records(0, 10), sorted_flag=True),
         write(d / "e.ibu", sorted_records(0, 0), sorted_flag=True),
         write(d / "b.ibu", sorted_records(10, 20), sorted_flag=True)], "out.ibu"),
    "dimension mismatch": lambda d: (
        [write(d / "a.ibu", sorted_records(0, 5), bc_len=8),
         write(d / "b.ibu", sorted_records(0, 5), bc_len=16)], "out.ibu"),
    "no inputs": lambda d: ([], "out.ibu"),
    "lying flag raises during the copy": lambda d: (
        [write(d / "a.ibu", sorted_records(0, 100), sorted_flag=True),
         write(d / "b.ibu", interior_dip(100, 200), sorted_flag=True)], "out.ibu"),
    "gzip input and gzip output": lambda d: (
        [write(d / "a.ibu.gz", sorted_records(0, 40), sorted_flag=True, compression="auto"),
         write(d / "b.ibu", sorted_records(40, 90), sorted_flag=True)], "out.ibu.gz"),
    "one file": lambda d: ([write(d / "a.ibu", sorted_records(0, 33))], "out.ibu"),
}


def read_maybe_gzip(path):
    with open(path, "rb") as f:
        raw = f.read()
    return gzip.decompress(raw) if raw[:2] == b"\x1f\x8b" else raw


@pytest.mark.parametrize("case", list(CONCAT_CASES))
def test_concat_files_matches_jax(tmp_path, case):
    paths, out_name = CONCAT_CASES[case](tmp_path)
    jo, to = str(tmp_path / f"j_{out_name}"), str(tmp_path / f"t_{out_name}")
    j = outcome(JPL.concat_files, paths, jo)
    t = outcome(TPL.concat_files, paths, to)
    same(j, t)
    if j[0] == "ok":
        assert read_maybe_gzip(jo) == read_maybe_gzip(to)
    else:
        # a failed copy leaves no output behind, in either package
        assert not (tmp_path / f"t_{out_name}").exists()
        assert not (tmp_path / f"j_{out_name}").exists()


def test_concat_lying_flag_names_the_file(tmp_path):
    paths, _ = CONCAT_CASES["lying flag raises during the copy"](tmp_path)
    with pytest.raises(ValueError, match="b.ibu: records are not in sorted order despite"):
        TPL.concat_files(paths, str(tmp_path / "o.ibu"))


@pytest.mark.parametrize("n,shards", [(997, 4), (5, 8)])
def test_split_concat_round_trip_is_byte_identical(tmp_path, n, shards):
    src = write(tmp_path / "src.ibu", sorted_records(0, n), sorted_flag=True)
    parts = TPL.split_file(src, str(tmp_path / "s{}.ibu"), shards)
    out = str(tmp_path / "rt.ibu")
    assert TPL.concat_files(parts, out) == {"records": n, "files": shards, "sorted": True}
    same_files(out, src)


@pytest.mark.parametrize("compression", [None, "auto"])
def test_boundary_records_match_jax(tmp_path, compression):
    name = "b.ibu.gz" if compression else "b.ibu"
    path = write(tmp_path / name, sorted_records(3, 90), compression=compression)
    assert TPL._boundary_records(path) == JPL._boundary_records(path)
    empty = write(tmp_path / ("e" + name), sorted_records(0, 0), compression=compression)
    assert TPL._boundary_records(empty) is None and JPL._boundary_records(empty) is None


# -- repair -----------------------------------------------------------------


def obliterate_header(raw):
    raw[:32] = b"\xde\xad" * 16
    return raw


REPAIR_CASES = {
    "truncated tail": (lambda d: corrupt(
        write(d / "t.ibu", sorted_records(0, 10_000), sorted_flag=True),
        lambda raw: raw[:-13]), {}),
    "cut in the first record": (lambda d: corrupt(
        write(d / "c.ibu", sorted_records(0, 10), sorted_flag=True),
        lambda raw: raw[:40]), {}),
    "lying sorted flag": (lambda d: write(d / "l.ibu", sorted_records(0, 100)[::-1].copy(),
                                          sorted_flag=True), {}),
    "unclaimed order": (lambda d: write(d / "u.ibu", sorted_records(0, 50)), {}),
    "clean unsorted": (lambda d: write(d / "r.ibu", random_records(500, 20)),
                       {"buffer_records": 64}),
    "destroyed header": (lambda d: corrupt(
        write(d / "h.ibu", sorted_records(0, 20), bc_len=9, umi_len=5, sorted_flag=True),
        obliterate_header), {}),
    "destroyed header, forced dims": (lambda d: corrupt(
        write(d / "h.ibu", sorted_records(0, 20), bc_len=9, umi_len=5, sorted_flag=True),
        obliterate_header), {"bc_len": 9, "umi_len": 5}),
    "one forced dim": (lambda d: write(d / "x.ibu", sorted_records(0, 5)), {"bc_len": 4}),
    "tiny fragment": (lambda d: corrupt(write(d / "f.ibu", sorted_records(0, 1)),
                                        lambda raw: raw[:6]), {}),
    "empty records": (lambda d: write(d / "e.ibu", sorted_records(0, 0), sorted_flag=True), {}),
    "torn gzip": (lambda d: corrupt(
        write(d / "g.ibu.gz", sorted_records(0, 5000), sorted_flag=True, compression="auto"),
        lambda raw: raw[: len(raw) // 2]), {"salvage_chunk_bytes": 2400}),
    "whole gzip": (lambda d: write(d / "w.ibu.gz", sorted_records(0, 700), sorted_flag=True,
                                   compression="auto"), {}),
}
ZSTD_REPAIR_CASES = {
    "torn zstd": (lambda d: corrupt(
        write(d / "r.ibu.zst", sorted_records(0, 50_000), sorted_flag=True, compression="auto"),
        lambda raw: raw[: len(raw) // 2]), {}),
}


@pytest.mark.parametrize("case", list(REPAIR_CASES) + list(ZSTD_REPAIR_CASES))
def test_repair_file_matches_jax(tmp_path, case):
    if case in ZSTD_REPAIR_CASES and not HAVE_ZSTD:
        pytest.skip("zstandard not installed")
    make, kwargs = {**REPAIR_CASES, **ZSTD_REPAIR_CASES}[case]
    path = make(tmp_path)
    j, t, jo, to = both("repair_file", tmp_path, [path], "fixed.ibu", **kwargs)
    same(j, t)
    if j[0] == "ok":
        same_files(jo, to)
    if case == "truncated tail":
        assert t[1]["records"] == 9999 and t[1]["dropped_bytes"] == 11 and t[1]["sorted"]
        assert TPL.check_file(to)["ok"]
    if case == "tiny fragment":
        assert t[1] == "IbuError" and t[2].endswith("only 6 bytes total; nothing to salvage")


# -- subsample --------------------------------------------------------------


def subsample_input(d, n=10_000, sorted_flag=True, compression=None):
    i = np.arange(n, dtype=np.uint64)
    name = "in.ibu.gz" if compression else "in.ibu"
    return write(d / name, make_records(i, i % np.uint64(13), i), sorted_flag=sorted_flag,
                 compression=compression)


SUBSAMPLE_CASES = {
    "n with small batches": ({}, {"n": 777, "seed": 42, "batch_records": 1024}),
    "fraction": ({"n": 1000}, {"fraction": 0.25, "seed": 1}),
    "another seed": ({"n": 1000}, {"fraction": 0.25, "seed": 2}),
    "none": ({"n": 100}, {"n": 0}),
    "all": ({"n": 100}, {"n": 100}),
    "fraction one": ({"n": 100}, {"fraction": 1.0}),
    "unsorted flag carries": ({"n": 50, "sorted_flag": False}, {"n": 10}),
    "gzip input": ({"compression": "auto"}, {"n": 500, "seed": 7, "batch_records": 1024}),
    "empty file": ({"n": 0}, {"n": 0}),
    "neither": ({"n": 10}, {}),
    "both": ({"n": 10}, {"fraction": 0.5, "n": 3}),
    "fraction out of range": ({"n": 10}, {"fraction": 1.5}),
    "n out of range": ({"n": 10}, {"n": 11}),
}


@pytest.mark.parametrize("case", list(SUBSAMPLE_CASES))
def test_subsample_file_matches_jax(tmp_path, case):
    make_kwargs, kwargs = SUBSAMPLE_CASES[case]
    path = subsample_input(tmp_path, **make_kwargs)
    j, t, jo, to = both("subsample_file", tmp_path, [path], "sub.ibu", **kwargs)
    same(j, t)
    if j[0] == "ok":
        same_files(jo, to)


def test_subsample_is_sorted_subset_of_exact_size(tmp_path):
    from ibu_tpu_torch import MmapReader

    path = subsample_input(tmp_path)
    out = str(tmp_path / "o.ibu")
    assert TPL.subsample_file(path, out, n=777, seed=3, batch_records=1000) == {
        "records": 10_000, "sampled": 777, "seed": 3}
    r = MmapReader(out)
    got = np.asarray(r.records)["index"]
    assert len(r) == 777 and r.header().sorted()
    assert len(np.unique(got)) == 777 and np.all(np.diff(got.astype(np.int64)) > 0)
