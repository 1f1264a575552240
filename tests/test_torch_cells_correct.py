"""Cell calling, barcode correction and the single-cell workflow, the port
against the JAX package on the CPU.

The cases mirror the reference's own (``tests/test_cells.py``,
``tests/test_correct.py``, ``examples/workflow.py``) on the same seeded
inputs. Tolerance 0 everywhere: file bytes, integers, status codes, dicts and
error texts. ``torch_knee_index`` and ``lax_knee_index`` both compute the
curve in float32; on the curves here (planted knees and the reference's
random curves) their indices are required to be equal, 0 ranks apart.
"""

import hashlib
import inspect
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ibu_tpu import Header, MmapReader, Writer
from ibu_tpu import pipelines as JPL
from ibu_tpu.constructs.record import make_records
from ibu_tpu.ops import codec as JCodec
from ibu_tpu.ops import correct as JC
from ibu_tpu.ops import knee as JK
from ibu_tpu_torch import pipelines as TPL
from ibu_tpu_torch.examples import workflow as TW
from ibu_tpu_torch.ops import correct as TC
from ibu_tpu_torch.ops import knee as TK
from tests.test_torch_cli import port_text

CPU = "cpu"
REPO = Path(__file__).resolve().parents[1]


def planted(rng, n_cells=40, n_ambient=400, cell_lo=50, cell_hi=101, amb_hi=4):
    """Barcode/count table with a clean gap between cells and ambient (the
    reference's ``_planted``)."""
    barcodes = rng.choice(1 << 32, n_cells + n_ambient, replace=False).astype(np.uint64)
    counts = np.concatenate([rng.integers(cell_lo, cell_hi, n_cells),
                             rng.integers(1, amb_hi, n_ambient)]).astype(np.int64)
    return barcodes[:n_cells], barcodes, counts


def records_with_counts(barcodes, counts, rng):
    bc = np.repeat(barcodes, counts)
    rng.shuffle(bc)
    n = len(bc)
    return make_records(bc, rng.integers(0, 1 << 24, n).astype(np.uint64),
                        np.arange(n, dtype=np.uint64))


def write(path, recs, bc_len=16, umi_len=12, sorted_flag=False, **kw):
    header = Header.new(bc_len, umi_len)
    if sorted_flag:
        header.set_sorted()
    with Writer.from_path(str(path), header, **kw) as w:
        w.write_batch(recs)
    return str(path)


def same_error(jax_call, torch_call, exc=ValueError):
    with pytest.raises(exc) as jax_err:
        jax_call()
    with pytest.raises(exc) as torch_err:
        torch_call()
    assert str(torch_err.value) == port_text(str(jax_err.value))


# ---------------------------------------------------------------------------
# knee
# ---------------------------------------------------------------------------


def knee_curves():
    rng = np.random.default_rng(11)
    curves = [np.sort(planted(np.random.default_rng(s))[2])[::-1].copy() for s in (3, 5, 7)]
    curves += [np.sort(rng.integers(1, 1000, int(rng.integers(3, 500))))[::-1].astype(np.int64)
               for _ in range(20)]
    curves += [np.array([5]), np.array([5, 4]), np.array([3, 3, 3, 3]),
               np.array([1000] * 100 + [1] * 900, dtype=np.int64), np.array([], np.int64)]
    return curves


@pytest.mark.parametrize("curve", knee_curves(), ids=lambda c: f"n{len(c)}")
def test_knee_estimators_equal(curve):
    if len(curve):
        assert TK.np_knee_index(curve) == JK.np_knee_index(curve)
    assert TK.knee_threshold(curve) == JK.knee_threshold(curve)
    for expect in (1, 40, 100, 3000):
        assert TK.ordmag_threshold(curve, expect) == JK.ordmag_threshold(curve, expect)


@pytest.mark.parametrize("curve", knee_curves()[:-1], ids=lambda c: f"n{len(c)}")
def test_torch_knee_index_equals_lax(curve):
    got = TK.torch_knee_index(curve, device=CPU)
    assert got.dtype == torch.int64 and got.ndim == 0
    assert int(got) == int(JK.lax_knee_index(curve)) == JK.np_knee_index(curve)


@pytest.mark.parametrize("method,expect,min_count", [
    ("knee", 3000, 1), ("ordmag", 40, 1), ("ordmag", 3000, 1), ("knee", 3000, 60)])
def test_call_from_counts_equal(method, expect, min_count):
    rng = np.random.default_rng(3)
    _, barcodes, counts = planted(rng)
    counts[::17] = 0  # dense-table zero slots are dropped
    got = TK.call_from_counts(barcodes, counts, method, expect, min_count)
    want = JK.call_from_counts(barcodes, counts, method, expect, min_count)
    assert np.array_equal(got[0], want[0]) and got[0].dtype == want[0].dtype
    assert got[1] == want[1]
    ties = np.array([9, 1, 5, 7], np.uint64), np.array([10, 10, 10, 2], np.int64)
    assert np.array_equal(TK.call_from_counts(*ties, min_count=3)[0],
                          JK.call_from_counts(*ties, min_count=3)[0])


def test_knee_errors_equal():
    barcodes = np.arange(4, dtype=np.uint64)
    counts = np.array([100, 100, 100, 1], dtype=np.int64)
    same_error(lambda: JK.call_from_counts(barcodes, counts, method="spline"),
               lambda: TK.call_from_counts(barcodes, counts, method="spline"))
    same_error(lambda: JK.call_from_counts(barcodes, counts[:2]),
               lambda: TK.call_from_counts(barcodes, counts[:2]))
    same_error(lambda: JK.call_from_counts(barcodes, np.array([5, -1, 2, 1])),
               lambda: TK.call_from_counts(barcodes, np.array([5, -1, 2, 1])))
    same_error(lambda: JK.np_knee_index(np.array([5, 3, 0])),
               lambda: TK.np_knee_index(np.array([5, 3, 0])))


# ---------------------------------------------------------------------------
# correction
# ---------------------------------------------------------------------------


def correction_case(length, seed):
    """A sorted allowlist and unique queries: exact members, one-error and
    two-error mutants, and random words (over the full 64 bits at length
    32, so bit 63 is set in about half of them)."""
    rng = np.random.default_rng(seed)
    deltas = JC.variant_deltas(length)

    def words(k):
        if length == 32:
            return rng.integers(0, 1 << 64, k, dtype=np.uint64)
        return rng.integers(0, 1 << (2 * length), k, dtype=np.uint64)

    allow = np.unique(words(300 if length > 4 else 1))
    one = allow[rng.integers(0, len(allow), 120)] ^ deltas[rng.integers(0, len(deltas), 120)]
    two = one ^ deltas[rng.integers(0, len(deltas), 120)]
    uniq = np.unique(np.concatenate([allow[:60], one, two, words(400)]))
    return uniq, allow


LENGTHS = [1, 12, 16, 17, 32]


def test_variant_deltas_equal():
    for length in (1, 2, 15, 16, 17, 32):
        assert np.array_equal(TC.variant_deltas(length), JC.variant_deltas(length))
    for bad in (0, 33):
        same_error(lambda: JC.variant_deltas(bad), lambda: TC.variant_deltas(bad))


@pytest.mark.parametrize("length", LENGTHS)
def test_torch_correct_unique_equals_numpy_and_lax(length):
    uniq, allow = correction_case(length, length)
    want = JC.np_correct_unique(uniq, allow, length)
    assert all(np.array_equal(a, b) for a, b in zip(TC.np_correct_unique(uniq, allow, length),
                                                    want))
    fixed, status = TC.torch_correct_unique(torch.from_numpy(uniq.view(np.int64)),
                                            torch.from_numpy(allow.view(np.int64)), length)
    assert fixed.dtype == torch.int64 and status.dtype == torch.uint8
    assert np.array_equal(fixed.numpy().view(np.uint64), want[0])
    assert np.array_equal(status.numpy(), want[1])
    assert set(want[1].tolist()) == ({JC.EXACT, JC.CORRECTED} if length == 1
                                     else {JC.DROP, JC.EXACT, JC.CORRECTED})
    if length == 32:
        assert (uniq >> np.uint64(63)).any() and (allow >> np.uint64(63)).any()
    if length <= 16:
        lax = JC.lax_correct_unique(uniq, allow, length)
        assert np.array_equal(lax[0], want[0]) and np.array_equal(lax[1], want[1])


@pytest.mark.parametrize("length", LENGTHS)
def test_correct_batch_equals_reference(length):
    uniq, allow = correction_case(length, 100 + length)
    rng = np.random.default_rng(length)
    barcodes = uniq[rng.integers(0, len(uniq), 3000)]
    got = TC.correct_batch(barcodes, allow, length, device=CPU)
    want = JC.correct_batch(barcodes, allow, length)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("name,allow,queries,length", [
    ("ambiguous", ["AAAA", "CAAA"], ["GAAA"], 4),
    ("exact beats neighbours", ["AAAA", "CAAA", "GAAA"], ["CAAA"], 4),
    ("empty allowlist", [], ["ACGT"], 4),
    ("no queries", ["ACGT"], [], 4),
])
def test_policy_edges(name, allow, queries, length):
    allow = np.sort(JCodec.encode_seqs(allow)) if allow else np.array([], np.uint64)
    queries = JCodec.encode_seqs(queries) if queries else np.array([], np.uint64)
    want = JC.np_correct_unique(queries, allow, length)
    got = TC.correct_batch(queries, allow, length, device=CPU)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_wide_values_take_the_same_path():
    # hi bits set despite length <= 16: the reference falls back to numpy,
    # the port's int64 path needs no fallback; the answers are equal
    wide = np.uint64(1) << np.uint64(40)
    allow = np.sort(np.array([5, int(wide)], np.uint64))
    barcodes = np.array([int(wide), 5, int(wide) ^ 1], np.uint64)
    got = TC.correct_batch(barcodes, allow, 16, device=CPU)
    want = JC.correct_batch(barcodes, allow, 16)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert got[1].tolist() == [JC.EXACT, JC.EXACT, JC.CORRECTED]


# ---------------------------------------------------------------------------
# call_cells and correct_file
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["knee", "ordmag"])
@pytest.mark.parametrize("engine", ["host", "device"])
def test_call_cells_matches_jax(tmp_path, method, engine):
    rng = np.random.default_rng(5)
    cells, barcodes, counts = planted(rng)
    src = write(tmp_path / "reads.ibu", records_with_counts(barcodes, counts, rng))
    kw = {"device": CPU} if engine == "device" else {}
    got = TPL.call_cells(src, str(tmp_path / "t.txt"), method=method, expect=40,
                         engine=engine, batch_records=1024, **kw)
    want = JPL.call_cells(src, str(tmp_path / "j.txt"), method=method, expect=40,
                          engine=engine, batch_records=1024)
    assert got == want and got["cells"] == 40
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    listed = (tmp_path / "t.txt").read_text().split()
    assert set(TPL.C.encode_seqs(listed).tolist()) == set(cells.tolist())


def test_call_cells_compressed_input_rejected(tmp_path):
    import gzip

    path = tmp_path / "x.ibu.gz"
    path.write_bytes(gzip.compress(b"\x00" * 64))
    same_error(lambda: JPL.call_cells(str(path), str(tmp_path / "j.txt")),
               lambda: TPL.call_cells(str(path), str(tmp_path / "t.txt")))


def pack(seqs):
    return JCodec.encode_seqs(list(seqs))


def reads_file(tmp_path, name, seqs, length):
    n = len(seqs)
    recs = make_records(pack(seqs), np.arange(n, dtype=np.uint64), np.arange(n, dtype=np.uint64))
    return write(tmp_path / name, recs, length, 6)


def correct_both(tmp_path, src, allow, **kw):
    t = TPL.correct_file(src, str(tmp_path / "t.ibu"), allow, device=CPU, **kw)
    j = JPL.correct_file(src, str(tmp_path / "j.ibu"), allow, **kw)
    assert t == j
    assert (tmp_path / "t.ibu").read_bytes() == (tmp_path / "j.ibu").read_bytes()
    return t


@pytest.mark.parametrize("keep_unmatched", [False, True])
def test_correct_file_end_to_end(tmp_path, keep_unmatched):
    src = reads_file(tmp_path, "in.ibu", ["AAAA", "AAAT", "CCCC", "GCCC", "TTTT", "ACCC"], 4)
    stats = correct_both(tmp_path, src, pack(["AAAA", "CCCC", "GGGG"]),
                         keep_unmatched=keep_unmatched)
    assert stats == {"records": 6, "exact": 2, "corrected": 3, "dropped": 1, "allowlist": 3}


@pytest.mark.parametrize("seqs,allow,is_sorted", [
    (["AAAT", "AAAA", "AATA"], ["AAAA"], True),  # all map to AAAA, indices ascend
    (["CCCC", "AAAA"], ["AAAA", "CCCC"], False),  # correction breaks the order
    (["TTTT"], ["AAAA"], False),  # nothing written: the flag stays clear
])
def test_correct_file_sorted_flag(tmp_path, seqs, allow, is_sorted):
    correct_both(tmp_path, reads_file(tmp_path, "s.ibu", seqs, 4), pack(allow))
    assert MmapReader(str(tmp_path / "t.ibu")).header().sorted() == is_sorted


@pytest.mark.parametrize("length,keep_unmatched", [(16, False), (16, True), (32, False)])
def test_correct_file_random_batches(tmp_path, length, keep_unmatched):
    uniq, allow = correction_case(length, 7 * length)
    rng = np.random.default_rng(length)
    n = 5000
    recs = make_records(uniq[rng.integers(0, len(uniq), n)],
                        rng.integers(0, 1 << 24, n, dtype=np.uint64),
                        rng.integers(0, 50, n, dtype=np.uint64))
    src = write(tmp_path / "r.ibu", np.sort(recs, order=("barcode", "umi", "index")),
                length, 12, sorted_flag=True)
    stats = correct_both(tmp_path, src, allow, batch_records=700,
                         keep_unmatched=keep_unmatched)
    assert stats["corrected"] > 0 and stats["dropped"] > 0


def test_correct_file_compressed_input(tmp_path):
    gz = write(tmp_path / "z.ibu.gz", make_records(*(np.arange(5, dtype=np.uint64),) * 3), 8, 6,
               compression="gzip")
    same_error(lambda: JPL.correct_file(gz, str(tmp_path / "j.ibu"), [1]),
               lambda: TPL.correct_file(gz, str(tmp_path / "t.ibu"), [1], device=CPU))


# ---------------------------------------------------------------------------
# the workflow as a whole
# ---------------------------------------------------------------------------


def stage_lines(text):
    """The stage lines with their timings, rates and paths taken out."""
    lines = [l for l in text.splitlines() if l.startswith("[")]
    # a timing stands alone in parentheses or closes them ("(... reads, 0.01s)");
    # a path follows an arrow and holds a slash (a count after an arrow stays)
    return [re.sub(r"\(\d[^)]*s\)|, [\d.]+s\)|-> \S*/\S+", "", l) for l in lines]


def test_workflow_stage_counts_equal_the_reference(tmp_path, capsys):
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    argv = ["--reads", "20000"]
    assert TW.main(argv + ["--device", "cpu", "--workdir", str(tmp_path / "t")]) == 0
    got = stage_lines(capsys.readouterr().out)
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    ref = subprocess.run([sys.executable, str(REPO / "examples" / "workflow.py"), *argv,
                          "--workdir", str(tmp_path / "j")],
                         capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert ref.returncode == 0, ref.stderr
    want = stage_lines(ref.stdout)
    assert [l.split()[0] for l in got] == ["[gen]", "[ingest]", "[cells]", "[correct]",
                                           "[dedup]", "[count]", "[verify]"]
    assert got == want
    for name in ("raw.ibu", "cells.txt", "corrected.ibu", "molecules.ibu",
                 "counts.barcodes.txt", "counts.indices.txt"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()


def generator_digest(make_ground_truth):
    allow, bc_rows, umi_rows, gene, truth = make_ground_truth(
        np.random.default_rng(4), 20, 7, 3000, 0.3)
    parts = [a.tobytes() for a in (allow, bc_rows, umi_rows, gene)] + [repr(sorted(truth.items()))]
    return hashlib.sha256(repr(parts).encode()).hexdigest()


def test_workflow_generator_is_the_reference_generator():
    """The port's copy of ``make_ground_truth`` against the reference's, run
    in its own process (importing ``examples/workflow.py`` sets jax options)."""
    code = ("import hashlib, sys\n"
            "import numpy as np\n"
            f"sys.path.insert(0, {str(REPO)!r})\n"
            "from examples.workflow import make_ground_truth\n"
            f"{inspect.getsource(generator_digest)}\n"
            "print(generator_digest(make_ground_truth))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"}, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == generator_digest(TW.make_ground_truth)
