"""The port's sample sort (``ibu_tpu_torch.parallel.sort``) against the JAX
package's (``ibu_tpu.parallel.sort``), exact.

The port runs in cohorts of 2 and 3 CPU ranks over Gloo (one launch each, all
checks of this module inside it: :mod:`tests.torch_cohort`); the JAX package
runs on a mesh of the same number of its virtual CPU devices. The sorted
arrays and files must be equal, each rank's share of the records must equal
the JAX shard's ``out_valid`` (the splitter rule is the reference's), and the
overflow and violated-hint errors must have the reference's texts.
"""

import jax
import numpy as np
import pytest

from ibu_tpu.constructs.record import make_records
from ibu_tpu.parallel import sort as JS
from ibu_tpu.parallel.device import make_mesh
from ibu_tpu_torch import Header, Writer
from ibu_tpu_torch.parallel import sort as TS
from tests.torch_cohort import launch

WORLDS = (2, 3)
N = 20_000
HINTS = {"bc_len": 16, "umi_len": 12, "index_bits": 32}


def _random(n, seed, bc_bits=32, umi_bits=24):
    rng = np.random.default_rng(seed)
    return make_records(
        rng.integers(0, 1 << bc_bits, n).astype(np.uint64),
        rng.integers(0, 1 << umi_bits, n).astype(np.uint64),
        np.arange(n, dtype=np.uint64),
    )


def _by_key(recs):
    return np.sort(recs, order=("barcode", "umi", "index"))


def _duplicates():
    # 60% of the records are ONE (bc, umi, index) triple: value routing alone
    # would flood one rank; the position word must spread it
    rng = np.random.default_rng(3)
    bc = np.where(rng.random(N) < 0.6, np.uint64(42), rng.integers(0, 1000, N).astype(np.uint64))
    return make_records(bc, np.zeros(N, np.uint64), np.zeros(N, np.uint64))


def _full_width():
    rng = np.random.default_rng(2)
    recs = make_records(
        rng.integers(0, 1 << 63, 5000).astype(np.uint64) * np.uint64(2),
        rng.integers(0, 1 << 63, 5000).astype(np.uint64),
        rng.integers(0, 1 << 63, 5000).astype(np.uint64) | np.uint64(1 << 63),
    )
    recs["barcode"][:5] = 0xFFFFFFFFFFFFFFFF  # sentinel-identical keys
    return recs


CASES = {
    "seeded": (_random(N, 1), HINTS),
    "duplicates": (_duplicates(), HINTS),
    "presorted": (_by_key(_random(N, 4)), HINTS),
    "reversed": (_by_key(_random(N, 5))[::-1].copy(), HINTS),
    "empty": (_random(0, 6), HINTS),
    "tiny": (_random(5, 7), HINTS),
    "full_width": (_full_width(), {}),
}


def jax_mesh(s):
    return make_mesh(jax.devices()[:s])


def jax_shares(records, s, kwargs, slack=2.0, q=256):
    """``out_valid`` of each JAX shard for ``records`` at ``s`` shards."""
    mesh = jax_mesh(s)
    hi_used = TS._hi_used(kwargs.get("bc_len"), kwargs.get("umi_len"), kwargs.get("index_bits"))
    dev_raw, dev_valid, local_n = JS._deal_to_shards(records, mesh)
    c_send = min(max(64, int(JS._cdiv(local_n, s) * slack)), local_n)
    mesh_key = (mesh.axis_names, tuple(d.id for d in mesh.devices.flat))
    program = JS._build_sort_program(mesh, mesh_key, local_n, c_send, q, hi_used)
    _, out_valid, _ = program(dev_raw, dev_valid)
    return np.asarray(out_valid).tolist()


def _write(path, records):
    with Writer.from_path(str(path), Header.new(16, 12)) as w:
        w.write_batch(records)
    return str(path)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_sort")
    paths = {}
    for name, (recs, _) in CASES.items():
        paths[name] = str(d / f"{name}.npy")
        np.save(paths[name], recs)
    paths["overflow"] = paths["seeded"]
    hint_bad = _random(1000, 8).copy()
    hint_bad["barcode"][7] = np.uint64(1 << 40)
    paths["hint"] = str(d / "hint.npy")
    np.save(paths["hint"], hint_bad)
    paths["file"] = _write(d / "in.ibu", _random(N, 9))
    return d, paths


@pytest.fixture(scope="module")
def cohorts(inputs):
    d, paths = inputs
    results = {}
    for s in WORLDS:
        tasks = [(name, "sharded_sort", {"path": paths[name], **kw})
                 for name, (_, kw) in CASES.items()]
        tasks += [
            ("overflow", "sharded_sort", {"path": paths["overflow"], "slack": 0.01, **HINTS}),
            ("hint", "sharded_sort", {"path": paths["hint"], **HINTS}),
            ("file", "sort_file_mesh", {"src": paths["file"], "dst": str(d / f"out{s}.ibu")}),
        ]
        results[s] = launch(s, tasks, d / f"cohort{s}")
    return results


def _ok(results, name):
    for r, got in enumerate(results):
        assert got[name][0] == "ok", (r, got[name])
    return [got[name][1] for got in results]


@pytest.mark.parametrize("s", WORLDS)
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_sort_equals_jax(cohorts, case, s):
    records, kwargs = CASES[case]
    got = _ok(cohorts[s], case)[0]["out"]
    want = JS.sharded_sort_records(records, mesh=jax_mesh(s), **kwargs)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _by_key(records))


@pytest.mark.parametrize("s", WORLDS)
@pytest.mark.parametrize("case", list(CASES))
def test_rank_shares_equal_jax_shards(cohorts, case, s):
    """Each rank's sorted run holds as many records as the JAX shard of the
    same index: the samples, their position word and the splitters are the
    reference's, not an equally valid rule of the port's own."""
    records, kwargs = CASES[case]
    matrices = [res["matrix"] for res in _ok(cohorts[s], case)]
    for m in matrices:  # every rank saw the same count matrix
        np.testing.assert_array_equal(m, matrices[0])
    assert matrices[0].sum(axis=0).tolist() == jax_shares(records, s, kwargs)


@pytest.mark.parametrize("s", WORLDS)
def test_overflow_raises_the_reference_text_on_every_rank(cohorts, s):
    records, _ = CASES["seeded"]
    with pytest.raises(ValueError) as want:
        JS.sharded_sort_records(records, mesh=jax_mesh(s), slack=0.01, **HINTS)
    assert "retry with a larger slack" in str(want.value)
    for got in cohorts[s]:
        assert got["overflow"] == ("err", "ValueError", str(want.value))


@pytest.mark.parametrize("s", WORLDS)
def test_violated_hint_raises_the_reference_text_on_every_rank(cohorts, inputs, s):
    with pytest.raises(ValueError) as want:
        JS.sharded_sort_records(np.load(inputs[1]["hint"]), mesh=jax_mesh(s), **HINTS)
    for got in cohorts[s]:
        assert got["hint"] == ("err", "ValueError", str(want.value))


@pytest.mark.parametrize("s", WORLDS)
def test_sort_file_mesh_equals_jax(cohorts, inputs, tmp_path, s):
    d, paths = inputs
    _ok(cohorts[s], "file")
    want = tmp_path / "want.ibu"
    JS.sort_file_mesh(paths["file"], str(want), mesh=jax_mesh(s))
    assert (d / f"out{s}.ibu").read_bytes() == want.read_bytes()


@pytest.mark.parametrize("case", list(CASES))
def test_outside_a_cohort_equals_jax(case):
    """A process in no cohort is a world of one: the local hinted sort."""
    records, kwargs = CASES[case]
    got = TS.sharded_sort_records(records, device="cpu", **kwargs)
    np.testing.assert_array_equal(got, JS.sharded_sort_records(records, mesh=jax_mesh(1), **kwargs))


def test_outside_a_cohort_violated_hint_matches_jax(inputs):
    records = np.load(inputs[1]["hint"])
    with pytest.raises(ValueError) as want:
        JS.sharded_sort_records(records, mesh=jax_mesh(1), **HINTS)
    with pytest.raises(ValueError) as got:
        TS.sharded_sort_records(records, device="cpu", **HINTS)
    assert str(got.value) == str(want.value)


def test_sort_file_mesh_outside_a_cohort_equals_jax(inputs, tmp_path):
    src = inputs[1]["file"]
    got_header = TS.sort_file_mesh(src, str(tmp_path / "got.ibu"), device="cpu")
    want_header = JS.sort_file_mesh(src, str(tmp_path / "want.ibu"), mesh=jax_mesh(1))
    assert got_header.as_bytes() == want_header.as_bytes()
    assert (tmp_path / "got.ibu").read_bytes() == (tmp_path / "want.ibu").read_bytes()


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 96, 97, 1000, 1 << 20, (1 << 20) + 1])
def test_shape_bucket_equals_jax(n):
    assert TS._shape_bucket(n) == JS._shape_bucket(n)
