"""The port's cohort file engines (``multihost_dedup_file``,
``multihost_filter_file``, ``multihost_correct_file``,
``multihost_count_matrix``, ``multihost_export_fastq`` and
``multihost_ingest_fastq``) against the JAX package's single-process
functions, exact.

The port runs in cohorts of 2 and 3 CPU ranks over Gloo, one launch each with
every case of this module inside it (:mod:`tests.torch_cohort`; a launch that
outlives its ``TIMEOUT`` fails, so a hang fails the tests). Every file the
cohort writes must equal, byte for byte, what ``ibu_tpu``'s function writes
in this process on the JAX CPU backend, and every rank must return its
result. The inputs are a few thousand records from a numpy seed: 16-base
barcodes and 12-base UMIs, and 32-base barcodes of which half have bit 63 set
(so an int64 comparison of gathered words would misorder them). A failure on
one rank must raise on every rank and leave no output, temporary or part
file; without a card, the engines that need one raise ``NoCardError`` on every
rank and write nothing.
"""

import gzip
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest

from ibu_tpu import pipelines as JPL
from ibu_tpu.constructs.record import make_records
from ibu_tpu.parallel.host import partition
from ibu_tpu_torch import Header, Writer
from ibu_tpu_torch.ops.codec import decode_seqs
from ibu_tpu_torch.utils.device import NO_CARD
from tests.torch_cohort import launch

WORLDS = (2, 3)
N = 4_000
BATCH = 333  # several batches per rank, a ragged last one
POOL = 60
HIGH = np.uint64(1 << 63)


def _write(path, records, sorted_flag=False, bc_len=16):
    header = Header.new(bc_len, 12)
    if sorted_flag:
        header.set_sorted()
    with Writer.from_path(str(path), header) as w:
        w.write_batch(records)
    return str(path)


def _by_key(records):
    return np.sort(records, order=("barcode", "umi", "index"))


def _fastq(reads, names=None, end=b"\n"):
    names = names or [b"r%d" % i for i in range(len(reads))]
    text = b"".join(b"@%s\n%s\n+\n%s\n" % (nm, r, b"I" * len(r)) for nm, r in zip(names, reads))
    return text[:-1] + end


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Every input, by name, and the allowlists."""
    d = tmp_path_factory.mktemp("multihost_files")
    rng = np.random.default_rng(2024)
    pool = rng.choice(1 << 32, POOL, replace=False).astype(np.uint64)
    bc = pool[rng.integers(0, POOL, N)]
    # a fifth of the barcodes carry one substituted base
    err = rng.random(N) < 0.2
    base = rng.integers(0, 16, N).astype(np.uint64)
    bc[err] ^= rng.integers(1, 4, N).astype(np.uint64)[err] << (np.uint64(2) * base[err])
    recs = make_records(bc, rng.integers(0, 8, N).astype(np.uint64),
                        rng.integers(0, 50, N).astype(np.uint64))
    f = {"dir": d, "allow": pool[:40], "filter": pool[::3]}
    f["plain"] = _write(d / "plain.ibu", recs)
    f["sorted"] = _write(d / "sorted.ibu", _by_key(recs), sorted_flag=True)
    f["lie"] = _write(d / "lie.ibu", recs, sorted_flag=True)

    # 32-base barcodes: exactly half of the records above bit 63, so the
    # sorted file's 2-rank boundary is where the sign of an int64 flips
    low = rng.choice(1 << 62, POOL // 2, replace=False).astype(np.uint64)
    wide_pool = np.concatenate([low, low * np.uint64(3) | HIGH])
    wbc = np.concatenate([low[rng.integers(0, POOL // 2, N // 2)],
                          wide_pool[POOL // 2:][rng.integers(0, POOL // 2, N // 2)]])
    rng.shuffle(wbc)
    wide = make_records(wbc, rng.integers(0, 1 << 24, N).astype(np.uint64),
                        rng.integers(0, 30, N).astype(np.uint64))
    f["wide_pool"] = wide_pool
    f["wide"] = _write(d / "wide.ibu", wide, bc_len=32)
    f["wide_sorted"] = _write(d / "wide_sorted.ibu", _by_key(wide), sorted_flag=True, bc_len=32)
    f["tiny"] = _write(d / "tiny.ibu", recs[:1])
    f["empty"] = _write(d / "empty.ibu", recs[:0], sorted_flag=True)

    # each rank's range of the cohort's size sorted on its own, each range's
    # barcodes below the one before: only the rank-boundary pairs break order
    for s in WORLDS:
        runs = []
        for r, (lo, hi) in enumerate(partition(N, s)):
            runs.append(_by_key(make_records(
                rng.integers(0, 500, hi - lo).astype(np.uint64) + np.uint64(1000 * (s - r)),
                rng.integers(0, 8, hi - lo).astype(np.uint64),
                rng.integers(0, 50, hi - lo).astype(np.uint64))))
        runs = np.concatenate(runs)
        f[f"boundary{s}"] = _write(d / f"boundary{s}.ibu", runs)
        f[f"boundary{s}_allow"] = np.unique(runs["barcode"])

    # FASTQs: the sorted file's reads; one read so small that a rank of three
    # has no line start in its byte range, ending without a newline; an
    # invalid base in read 0; a short read in the last rank's range
    sorted_recs = np.asarray(_by_key(recs))
    seqs = [(b + u).encode() for b, u in zip(decode_seqs(sorted_recs["barcode"], 16),
                                            decode_seqs(sorted_recs["umi"], 12))]
    f["fq"] = str(d / "reads.fastq")
    Path(f["fq"]).write_bytes(_fastq(seqs))
    f["fq_one"] = str(d / "one.fastq")
    Path(f["fq_one"]).write_bytes(_fastq([seqs[0] + b"ACGT" * 10], end=b""))
    bad = list(seqs[:300])
    bad[0] = bad[0][:5] + b"N" + bad[0][6:]
    f["fq_bad_base"] = str(d / "bad_base.fastq")
    Path(f["fq_bad_base"]).write_bytes(_fastq(bad))
    short = list(seqs[:300])
    short[290] = short[290][:20]
    f["fq_short"] = str(d / "short.fastq")
    Path(f["fq_short"]).write_bytes(_fastq(short))
    f["fq_gz"] = str(d / "reads.fastq.gz")
    Path(f["fq_gz"]).write_bytes(gzip.compress(Path(f["fq"]).read_bytes()))
    return f


def cases(f, s):
    """``(name, task, kwargs)`` of every cohort case of world ``s``, outputs
    under ``w{s}``; ``kwargs`` name the inputs of :func:`files`."""
    out = f["dir"] / f"w{s}"

    def o(name):
        return str(out / name)

    def call(name, fn, **kwargs):
        return (name, "call", {"fn": fn, **kwargs})

    plain, srt = f["plain"], f["sorted"]
    tasks = [
        call("dedup_sorted", "multihost_dedup_file", in_path=srt, out_path=o("dedup_sorted.ibu"),
             device="cpu", batch_records=BATCH),
        call("dedup_unsorted", "multihost_dedup_file", in_path=plain,
             out_path=o("dedup_unsorted.ibu"), device="cpu", batch_records=BATCH),
        call("dedup_mesh", "multihost_dedup_file", in_path=plain, out_path=o("dedup_mesh.ibu"),
             device="cpu", env="mesh"),
        call("dedup_presort", "multihost_dedup_file", in_path=srt, out_path=o("dedup_presort.ibu"),
             device="cpu", assume_sorted=False),
        call("dedup_wide", "multihost_dedup_file", in_path=f["wide"], out_path=o("dedup_wide.ibu"),
             device="cpu", batch_records=BATCH),
        call("dedup_tiny", "multihost_dedup_file", in_path=f["tiny"], out_path=o("dedup_tiny.ibu"),
             device="cpu"),
        call("dedup_lie", "multihost_dedup_file", in_path=f["lie"], out_path=o("dedup_lie.ibu"),
             device="cpu", batch_records=BATCH),
        call("filter", "multihost_filter_file", in_path=plain, out_path=o("filter.ibu"),
             barcodes=f["filter"], batch_records=BATCH),
        call("filter_invert", "multihost_filter_file", in_path=srt, out_path=o("filter_invert.ibu"),
             barcodes=f["filter"], invert=True, batch_records=BATCH),
        call("filter_wide", "multihost_filter_file", in_path=f["wide_sorted"],
             out_path=o("filter_wide.ibu"), barcodes=f["wide_pool"][::2]),
        call("correct", "multihost_correct_file", in_path=plain, out_path=o("correct.ibu"),
             barcodes=f["allow"], device="cpu", batch_records=BATCH),
        call("correct_keep", "multihost_correct_file", in_path=plain, out_path=o("correct_keep.ibu"),
             barcodes=f["allow"], device="cpu", keep_unmatched=True, batch_records=BATCH),
        call("correct_sorted", "multihost_correct_file", in_path=srt,
             out_path=o("correct_sorted.ibu"), barcodes=f["allow"], device="cpu"),
        call("correct_wide", "multihost_correct_file", in_path=f["wide_sorted"],
             out_path=o("correct_wide.ibu"), barcodes=f["wide_pool"], device="cpu"),
        call("correct_boundary", "multihost_correct_file", in_path=f[f"boundary{s}"],
             out_path=o("correct_boundary.ibu"), barcodes=f[f"boundary{s}_allow"], device="cpu",
             batch_records=BATCH),
    ]
    for name in ("plain", "sorted", "wide", "wide_sorted", "tiny", "empty"):
        for dedup in (True, False):
            key = f"count_{name}_{'dedup' if dedup else 'raw'}"
            tasks.append(call(key, "multihost_count_matrix", in_path=f[name], out_prefix=o(key),
                              dedup=dedup, batch_records=BATCH))
    tasks += [
        call("export", "multihost_export_fastq", ibu_path=srt, fastq_path=o("reads.fastq"),
             batch_records=BATCH, device="cpu"),
        call("export_device_codec", "multihost_export_fastq", ibu_path=srt,
             fastq_path=o("dev.fastq"), device="cpu", codec="device"),
        call("export_gz", "multihost_export_fastq", ibu_path=srt, fastq_path=o("reads.fastq.gz"),
             qual="#", device="cpu"),
        call("ingest", "multihost_ingest_fastq", fastq_path=f["fq"], ibu_path=o("ingest.ibu"),
             bc_len=16, umi_len=12, device="cpu"),
        call("ingest_batches", "multihost_ingest_fastq", fastq_path=f["fq"],
             ibu_path=o("ingest_batches.ibu"), bc_len=16, umi_len=12, batch=BATCH, device="cpu",
             codec="device"),
        call("ingest_mesh", "multihost_ingest_fastq", fastq_path=f["fq"],
             ibu_path=o("ingest_mesh.ibu"), bc_len=10, umi_len=8, device="cpu", env="mesh"),
        call("ingest_one", "multihost_ingest_fastq", fastq_path=f["fq_one"],
             ibu_path=o("ingest_one.ibu"), bc_len=16, umi_len=12, device="cpu"),
        call("ingest_bad_base", "multihost_ingest_fastq", fastq_path=f["fq_bad_base"],
             ibu_path=o("ingest_bad_base.ibu"), bc_len=16, umi_len=12, device="cpu"),
        call("ingest_short", "multihost_ingest_fastq", fastq_path=f["fq_short"],
             ibu_path=o("ingest_short.ibu"), bc_len=16, umi_len=12, device="cpu"),
        call("ingest_gz_in", "multihost_ingest_fastq", fastq_path=f["fq_gz"],
             ibu_path=o("ingest_gz_in.ibu"), bc_len=16, umi_len=12, device="cpu"),
        call("ingest_gz_out", "multihost_ingest_fastq", fastq_path=f["fq"],
             ibu_path=o("ingest_gz_out.ibu.gz"), bc_len=16, umi_len=12, device="cpu"),
    ]
    # rank 1's first write raises in each cooperative writer
    for key, fn, kwargs in (
        ("dedup", "multihost_dedup_file", {"in_path": srt, "out_path": o("fail_dedup.ibu"),
                                           "device": "cpu"}),
        ("filter", "multihost_filter_file", {"in_path": srt, "out_path": o("fail_filter.ibu"),
                                             "barcodes": f["filter"]}),
        ("correct", "multihost_correct_file", {"in_path": plain, "out_path": o("fail_correct.ibu"),
                                               "barcodes": f["allow"], "device": "cpu"}),
        ("count", "multihost_count_matrix", {"in_path": plain, "out_prefix": o("fail_count")}),
        ("ingest", "multihost_ingest_fastq", {"fastq_path": f["fq"], "ibu_path": o("fail_ingest.ibu"),
                                              "bc_len": 16, "umi_len": 12, "device": "cpu"}),
    ):
        tasks.append((f"fail_{key}", "call_failing_write_on_rank1", {"fn": fn, **kwargs}))
    tasks.append(("fail_export", "call_failing_export_on_rank1",
                  {"ibu_path": srt, "fastq_path": o("fail_export.fastq"), "device": "cpu"}))
    # no card, and no device named
    for key, fn, kwargs in (
        ("correct", "multihost_correct_file", {"in_path": plain, "out_path": o("nc_correct.ibu"),
                                               "barcodes": f["allow"]}),
        ("export", "multihost_export_fastq", {"ibu_path": srt, "fastq_path": o("nc_export.fastq")}),
        ("ingest", "multihost_ingest_fastq", {"fastq_path": f["fq"], "ibu_path": o("nc_ingest.ibu"),
                                              "bc_len": 16, "umi_len": 12}),
        ("dedup_unsorted", "multihost_dedup_file", {"in_path": plain,
                                                    "out_path": o("nc_dedup_unsorted.ibu")}),
        ("dedup_host", "multihost_dedup_file", {"in_path": plain, "out_path": o("nc_dedup_host.ibu"),
                                                "env": "host"}),
        ("dedup_sorted", "multihost_dedup_file", {"in_path": srt,
                                                  "out_path": o("nc_dedup_sorted.ibu")}),
        ("filter", "multihost_filter_file", {"in_path": srt, "out_path": o("nc_filter.ibu"),
                                             "barcodes": f["filter"]}),
        ("count", "multihost_count_matrix", {"in_path": srt, "out_prefix": o("nc_count")}),
    ):
        tasks.append((f"nocard_{key}", "call_without_card", {"fn": fn, **kwargs}))
    return tasks


@pytest.fixture(scope="module")
def cohorts(files):
    results = {}
    for s in WORLDS:
        (files["dir"] / f"w{s}").mkdir()
        results[s] = launch(s, cases(files, s), files["dir"] / f"w{s}" / "cohort")
    return results


def _ok(results, name):
    for r, got in enumerate(results):
        assert got[name][0] == "ok", (r, got[name])
    return [got[name][1] for got in results]


def _errs(results, name):
    return [got[name] for got in results]


def _pointer(stage):
    return ("err", "ValueError", f"multihost operation failed on another process during {stage} "
            "(see that rank's error)")


def _case(files, s, name):
    return next(kw for key, _, kw in cases(files, s) if key == name)


@lru_cache(maxsize=None)
def _jax_run(fn, out, **kwargs):
    """One JAX single-process call: ``(result or error text, bytes of each
    file it wrote under ``out``'s name)``."""
    d = Path(out).parent
    before = set(d.iterdir())
    try:
        got = getattr(JPL, fn)(**kwargs)
    except ValueError as e:
        got = ("err", str(e))
    written = {p.name: p.read_bytes() for p in sorted(set(d.iterdir()) - before)}
    return got, written


def jax(files, fn, name, **kwargs):
    """The JAX package's ``fn`` on the inputs of case ``name``, into a
    directory of its own: its result and the files it wrote."""
    d = files["dir"] / "jax" / name
    d.mkdir(parents=True, exist_ok=True)
    frozen = {k: tuple(v.tolist()) if isinstance(v, np.ndarray) else v for k, v in kwargs.items()}
    return _jax_run(fn, str(d / "out"), **frozen)


def _files(prefix: str) -> dict:
    p = Path(prefix)
    return {q.name.replace(p.name, "out", 1): q.read_bytes()
            for q in sorted(p.parent.iterdir()) if q.name.startswith(p.name)}


@pytest.mark.parametrize("s", WORLDS)
@pytest.mark.parametrize("name,assume", [
    ("dedup_sorted", None), ("dedup_unsorted", None), ("dedup_mesh", None),
    ("dedup_presort", False), ("dedup_wide", None), ("dedup_tiny", None),
])
def test_dedup_equals_jax(cohorts, files, s, name, assume):
    kw = _case(files, s, name)
    want, written = jax(files, "dedup_file", name, in_path=kw["in_path"],
                        out_path=str(files["dir"] / "jax" / name / "out"), assume_sorted=assume)
    assert _ok(cohorts[s], name) == [want] * s
    assert Path(kw["out_path"]).read_bytes() == written["out"]
    left = [p.name for p in Path(kw["out_path"]).parent.iterdir() if ".mhsort" in p.name]
    assert left == []


@pytest.mark.parametrize("s", WORLDS)
def test_a_lying_sorted_flag_fails_every_rank(cohorts, files, s):
    """The flag says sorted and the records are not: every rank raises the
    reference's text (the rank that saw it, its position), and no output."""
    kw = _case(files, s, "dedup_lie")
    got = _errs(cohorts[s], "dedup_lie")
    assert all(g[0] == "err" and g[1] == "ValueError" and "not in sorted order" in g[2]
               for g in got)
    assert got[0][2].startswith(f"{files['lie']}: records are not in sorted order near record ")
    want, _ = jax(files, "dedup_file", "dedup_lie", in_path=files["lie"],
                  out_path=str(files["dir"] / "jax" / "dedup_lie" / "out"))
    assert want[0] == "err" and got[0][2] == want[1]  # rank 0's range starts the file
    assert not Path(kw["out_path"]).exists()


@pytest.mark.parametrize("s", WORLDS)
@pytest.mark.parametrize("name,src,allow,invert", [
    ("filter", "plain", "filter", False),
    ("filter_invert", "sorted", "filter", True),
    ("filter_wide", "wide_sorted", "wide_half", False),
])
def test_filter_equals_jax(cohorts, files, s, name, src, allow, invert):
    barcodes = files["wide_pool"][::2] if allow == "wide_half" else files[allow]
    want, written = jax(files, "filter_file", name, in_path=files[src],
                        out_path=str(files["dir"] / "jax" / name / "out"), barcodes=barcodes,
                        invert=invert)
    assert _ok(cohorts[s], name) == [want] * s
    assert Path(_case(files, s, name)["out_path"]).read_bytes() == written["out"]


@pytest.mark.parametrize("s", WORLDS)
@pytest.mark.parametrize("name,src,allow,keep", [
    ("correct", "plain", "allow", False),
    ("correct_keep", "plain", "allow", True),
    ("correct_sorted", "sorted", "allow", False),
    ("correct_wide", "wide_sorted", "wide_pool", False),
    ("correct_boundary", "boundary", "boundary_allow", False),
])
def test_correct_equals_jax(cohorts, files, s, name, src, allow, keep):
    if src == "boundary":
        src, allow = f"boundary{s}", f"boundary{s}_allow"
    want, written = jax(files, "correct_file", f"{name}{s}", in_path=files[src],
                        out_path=str(files["dir"] / "jax" / f"{name}{s}" / "out"),
                        barcodes=files[allow], keep_unmatched=keep)
    assert _ok(cohorts[s], name) == [want] * s
    got = Path(_case(files, s, name)["out_path"]).read_bytes()
    assert got == written["out"]
    flag = got[16] & 1
    if name == "correct_wide":
        assert flag == 1  # every barcode exact: the sorted input stays sorted
    if name == "correct_boundary":
        assert flag == 0  # every rank's stream sorted, the boundary pairs not


@pytest.mark.parametrize("s", WORLDS)
@pytest.mark.parametrize("src", ["plain", "sorted", "wide", "wide_sorted", "tiny", "empty"])
@pytest.mark.parametrize("dedup", [True, False], ids=["dedup", "raw"])
def test_count_matrix_equals_jax_host(cohorts, files, s, src, dedup):
    key = f"count_{src}_{'dedup' if dedup else 'raw'}"
    want, written = jax(files, "count_matrix", key, in_path=files[src],
                        out_prefix=str(files["dir"] / "jax" / key / "out"), dedup=dedup,
                        engine="host")
    assert _ok(cohorts[s], key) == [want] * s
    assert _files(_case(files, s, key)["out_prefix"]) == written
    assert sorted(written) == ["out.barcodes.txt", "out.indices.txt", "out.mtx"]


@pytest.mark.parametrize("s", WORLDS)
@pytest.mark.parametrize("name", ["export", "export_device_codec", "export_gz"])
def test_export_shards_equal_jax_ranges(cohorts, files, s, name):
    kw = _case(files, s, name)
    got = _ok(cohorts[s], name)
    ranges = partition(N, s)
    stem, suffix = {"export": ("reads", ".fastq"), "export_device_codec": ("dev", ".fastq"),
                    "export_gz": ("reads", ".fastq.gz")}[name]
    qual = kw.get("qual", "I")
    whole, _ = jax(files, "export_fastq", f"{name}_whole", ibu_path=files["sorted"],
                   fastq_path=str(files["dir"] / "jax" / f"{name}_whole" / "out.fastq"), qual=qual)
    full = (files["dir"] / "jax" / f"{name}_whole" / "out.fastq").read_bytes()
    shards = []
    for r, (lo, hi) in enumerate(ranges):
        path = str(files["dir"] / f"w{s}" / f"{stem}.part{r}{suffix}")
        assert got[r] == (N, hi - lo, path)
        data = Path(path).read_bytes()
        if suffix.endswith(".gz"):
            data = gzip.decompress(data)
        n, _ = jax(files, "export_fastq", f"{name}_{s}_{r}", ibu_path=files["sorted"],
                   fastq_path=str(files["dir"] / "jax" / f"{name}_{s}_{r}" / "out.fastq"),
                   record_range=(lo, hi), qual=qual)
        assert n == hi - lo
        assert data == (files["dir"] / "jax" / f"{name}_{s}_{r}" / "out.fastq").read_bytes()
        shards.append(data)
    assert whole == N and b"".join(shards) == full


@pytest.mark.parametrize("s", WORLDS)
@pytest.mark.parametrize("name,bc,umi,batch", [
    ("ingest", 16, 12, 200_000),
    ("ingest_batches", 16, 12, BATCH),
    ("ingest_mesh", 10, 8, 200_000),
    ("ingest_one", 16, 12, 200_000),
])
def test_ingest_equals_jax(cohorts, files, s, name, bc, umi, batch):
    kw = _case(files, s, name)
    want, written = jax(files, "ingest_fastq", name, fastq_path=kw["fastq_path"],
                        ibu_path=str(files["dir"] / "jax" / name / "out"), bc_len=bc,
                        umi_len=umi, batch=batch)
    assert _ok(cohorts[s], name) == [want] * s
    assert Path(kw["ibu_path"]).read_bytes() == written["out"]
    assert not Path(kw["ibu_path"] + ".mhingest.tmp").exists()


def test_one_rank_of_three_holds_no_line_start(files):
    """The one-read FASTQ leaves a rank of three without a line of its own."""
    data = Path(files["fq_one"]).read_bytes()
    starts = [0] + [i + 1 for i, c in enumerate(data) if c == 10]
    assert data[-1:] != b"\n"
    assert any(not any(lo <= p < hi for p in starts) for lo, hi in partition(len(data), 3))


@pytest.mark.parametrize("s", WORLDS)
@pytest.mark.parametrize("name", ["ingest_bad_base", "ingest_short"])
def test_a_bad_read_fails_every_rank_with_the_reference_text(cohorts, files, s, name):
    """The rank that parses the bad read raises the single-process text (the
    short read's global line number; the invalid base of read 0, which rank
    0's first batch holds at the same position), the others the pointer."""
    kw = _case(files, s, name)
    want, _ = jax(files, "ingest_fastq", name, fastq_path=kw["fastq_path"],
                  ibu_path=str(files["dir"] / "jax" / name / "out"), bc_len=16, umi_len=12)
    assert want[0] == "err"
    got = _errs(cohorts[s], name)
    bad = 0 if name == "ingest_bad_base" else s - 1
    assert got[bad] == ("err", "ValueError", want[1])
    assert [g for r, g in enumerate(got) if r != bad] == [_pointer("the parse/encode pass")] * (s - 1)
    assert not any(p.name.startswith(name) for p in (files["dir"] / f"w{s}").iterdir())


@pytest.mark.parametrize("s", WORLDS)
@pytest.mark.parametrize("name,text", [
    ("ingest_gz_in", "{fq_gz} is gzip-compressed: no random access to shard it across hosts — "
                     "decompress first, or ingest single-host (compressed ingest streams fine "
                     "there)"),
    ("ingest_gz_out", "compressed output cannot be pwritten cooperatively; use a plain .ibu "
                      "output (compress it afterwards if needed)"),
])
def test_compressed_ingest_is_refused_on_every_rank(cohorts, files, s, name, text):
    assert _errs(cohorts[s], name) == [("err", "ValueError", text.format(**files))] * s
    assert not any(p.name.startswith(name) for p in (files["dir"] / f"w{s}").iterdir())


@pytest.mark.parametrize("s", WORLDS)
@pytest.mark.parametrize("key,stage", [
    ("dedup", "the write pass"), ("filter", "the write pass"), ("correct", "the write pass"),
    ("count", "the write pass"), ("ingest", "the parse/encode pass"), ("export", "the export"),
])
def test_a_failure_on_rank1_ends_every_rank_and_leaves_nothing(cohorts, files, s, key, stage):
    got = _errs(cohorts[s], f"fail_{key}")
    assert got[1] == ("err", "OSError", "injected failure on rank 1")
    assert [g for r, g in enumerate(got) if r != 1] == [_pointer(stage)] * (s - 1)
    left = sorted(p.name for p in (files["dir"] / f"w{s}").iterdir()
                  if p.name.startswith(f"fail_{key}"))
    assert left == []


@pytest.mark.parametrize("s", WORLDS)
@pytest.mark.parametrize("key", ["correct", "export", "ingest", "dedup_unsorted"])
def test_without_a_card_every_rank_raises_no_card(cohorts, files, s, key):
    """No card and no device named: each rank finds it before any write,
    through a checkpoint, and raises ``NoCardError``."""
    got = _errs(cohorts[s], f"nocard_{key}")
    assert [g[:2] for g in got] == [("err", "NoCardError")] * s
    assert all(g[2].endswith(NO_CARD) for g in got)
    assert not any(p.name.startswith(f"nc_{key}") for p in (files["dir"] / f"w{s}").iterdir())


@pytest.mark.parametrize("s", WORLDS)
@pytest.mark.parametrize("key,fn,src,kwargs", [
    ("dedup_host", "dedup_file", "plain", {}),
    ("dedup_sorted", "dedup_file", "sorted", {}),
    ("filter", "filter_file", "sorted", {"barcodes": "filter"}),
    ("count", "count_matrix", "sorted", {}),
])
def test_the_host_engines_need_no_card(cohorts, files, s, key, fn, src, kwargs):
    """Filter, count and a sorted dedup are numpy; an unsorted dedup under
    ``IBU_POD_SORT_ENGINE=host`` sorts with the native external sort."""
    kw = _case(files, s, f"nocard_{key}")
    out = str(files["dir"] / "jax" / f"nc_{key}" / "out")
    args = {"in_path": files[src], ("out_prefix" if fn == "count_matrix" else "out_path"): out,
            **{k: files[v] for k, v in kwargs.items()}}
    want, written = jax(files, fn, f"nc_{key}", **args)
    assert _ok(cohorts[s], f"nocard_{key}") == [want] * s
    if fn == "count_matrix":
        assert _files(kw["out_prefix"]) == written
    else:
        assert Path(kw["out_path"]).read_bytes() == written["out"]
