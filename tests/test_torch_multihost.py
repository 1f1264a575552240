"""The port's cohort engines (``ibu_tpu_torch.parallel.multihost``) against
the JAX package's single-process results, exact.

The port runs in cohorts of 2 and 3 CPU ranks over Gloo, one launch each with
every check of this module inside it (:mod:`tests.torch_cohort`; a launch
that outlives its ``TIMEOUT`` of 240 s fails, so a hang fails the tests). Every rank must return the JAX package's
dict, or write the bytes of ``ibu_tpu.native.sort_file``; the engine choice
must be the same on every rank; and a failure on one rank must raise on
every rank, with the reference's texts.
"""

import functools

import jax
import numpy as np
import pytest

from ibu_tpu import Header as JHeader
from ibu_tpu import Writer as JWriter
from ibu_tpu import native as JN
from ibu_tpu.constructs.record import make_records
from ibu_tpu.errors import InvalidMapSize as JInvalidMapSize
from ibu_tpu.parallel import device as JD
from ibu_tpu.parallel import multihost as JMH
from ibu_tpu_torch import native as TN
from ibu_tpu_torch.errors import InvalidMapSize
from ibu_tpu_torch.ops.u64 import stats_state_from_jax
from tests.torch_cohort import launch

WORLDS = (2, 3)
N = 6_000
BATCH = 700  # several batches per rank, a ragged last one
CAPACITY = 256  # under the 300 barcodes of the histogram file


def _write(path, records, sorted_flag=False, bc_len=16):
    header = JHeader.new(bc_len, 12)
    if sorted_flag:
        header.set_sorted()
    with JWriter.from_path(str(path), header) as w:
        w.write_batch(records)
    return str(path)


def _records(n, seed, barcodes, high=0):
    rng = np.random.default_rng(seed)
    return make_records(
        rng.integers(0, barcodes, n).astype(np.uint64) | np.uint64(high),
        rng.integers(0, 1 << 24, n).astype(np.uint64),
        rng.integers(0, 1 << 63, n).astype(np.uint64) * np.uint64(2),
    )


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("multihost")
    recs = _records(N, 11, 300)
    f = {
        "plain": _write(d / "plain.ibu", recs),
        "sorted": _write(d / "sorted.ibu", np.sort(recs, order=("barcode", "umi", "index")),
                         sorted_flag=True),
        # 24-base barcodes: keys with a nonzero hi word
        "wide": _write(d / "wide.ibu", _records(N, 12, 1 << 20, high=1 << 40), bc_len=24),
        "dir": d,
    }
    return f


def jax_mesh(s):
    return JD.make_mesh(jax.devices()[:s])


@functools.lru_cache(maxsize=None)
def jax_result(fn, path, **kwargs):
    """One JAX call per file and options, shared by both cohort sizes."""
    try:
        return getattr(JMH, fn)(path, **kwargs)
    except ValueError as e:
        return e


def jax_stats_states(path, s):
    """The JAX stats engine's per-shard states ``(S, ...)`` over ``path``."""
    from ibu_tpu import MmapReader

    mesh = jax_mesh(s)
    step = JD.STATS_MAP_REDUCE.compile_step(mesh)
    states = JD.STATS_MAP_REDUCE.initial_states(mesh)
    for batch in JD.record_batches_from_mmap(MmapReader(path), BATCH):
        states = step(states, *JD.shard_batch(batch, mesh))
    return states


def jax_histogram_state(path):
    """A JAX device histogram over ``path``, merged: ``(host state, dict)``."""
    from ibu_tpu import MmapReader

    hist = JD.DeviceHistogram(mesh=jax_mesh(2), capacity=1 << 12)
    for batch in JD.record_batches_from_mmap(MmapReader(path), BATCH):
        hist.update(batch)
    hist._run_merge()
    return {k: np.asarray(v) for k, v in hist._state.items()}, hist


@pytest.fixture(scope="module")
def cohorts(files):
    d = files["dir"]
    results = {}
    for s in WORLDS:
        out = d / f"w{s}"
        out.mkdir()
        states = jax.tree.map(np.asarray, jax_stats_states(files["plain"], s))
        hstate, _ = jax_histogram_state(files["plain"])
        tasks = [
            ("backend", "backend", {}),
            ("stats", "file_stats", {"path": files["plain"], "batch_records": BATCH}),
            ("stats_sorted", "file_stats", {"path": files["sorted"]}),
            ("hist_spill", "histogram", {"path": files["plain"], "batch_records": BATCH,
                                         "capacity": 64}),
            ("hist_sorted", "histogram", {"path": files["sorted"], "batch_records": BATCH}),
            ("hist_wide", "histogram", {"path": files["wide"], "batch_records": BATCH,
                                        "capacity": 1024}),
            ("hist_strict", "histogram", {"path": files["sorted"], "batch_records": BATCH,
                                          "capacity": CAPACITY, "spill": False}),
            ("hist_strict_ok", "histogram", {"path": files["plain"], "batch_records": BATCH,
                                             "capacity": 512, "spill": False}),
            ("stacked", "map_reduce_stacked", {"path": files["plain"], "batch_records": BATCH}),
            ("collectives", "map_reduce_collectives", {"path": files["plain"]}),
            ("update_fails", "map_reduce_failing_on_rank1", {"path": files["plain"]}),
            ("resume_stats", "resume_stats", {"states": states}),
            ("resume_hist", "resume_histogram", {"state": hstate, "path": files["wide"],
                                                 "capacity": 1 << 12}),
        ]
        for engine in ("mesh", "host", "auto"):
            tasks.append((f"sort_{engine}", "sort_file",
                          {"src": files["plain"], "dst": str(out / f"{engine}.ibu"),
                           "engine": engine, "chunk_records": 500}))
        tasks += [
            ("sort_env_host", "sort_file", {"src": files["wide"], "dst": str(out / "env.ibu"),
                                            "env": "host"}),
            ("agree", "sort_file_rank1_without_native",
             {"src": files["plain"], "dst": str(out / "agree.ibu")}),
            ("bad_env", "sort_file_bad_override_on_rank1",
             {"src": files["plain"], "dst": str(out / "bad.ibu")}),
            ("fail_runs", "sort_file_failing_on_rank1",
             {"src": files["plain"], "dst": str(out / "fail_runs.ibu"),
              "stage": "sort_chunks_range"}),
            ("fail_merge", "sort_file_failing_on_rank1",
             {"src": files["plain"], "dst": str(out / "fail_merge.ibu"),
              "stage": "merge_runs_interval"}),
        ]
        results[s] = launch(s, tasks, out / "cohort")
    return results


def _ok(results, name):
    for r, got in enumerate(results):
        assert got[name][0] == "ok", (r, got[name])
    return [got[name][1] for got in results]


@pytest.fixture(scope="module")
def native_sorted(files, tmp_path_factory):
    d = tmp_path_factory.mktemp("native_sorted")
    out = {}
    for name in ("plain", "wide"):
        JN.sort_file(files[name], str(d / f"{name}.ibu"))
        out[name] = (d / f"{name}.ibu").read_bytes()
    return out


@pytest.mark.parametrize("s", WORLDS)
def test_the_cohort_exchanges_over_gloo_on_the_cpu(cohorts, s):
    got = _ok(cohorts[s], "backend")
    assert got == [{"exchange": "gloo", "rank": r, "world": s} for r in range(s)]


@pytest.mark.parametrize("s", WORLDS)
@pytest.mark.parametrize("name,file,kwargs", [
    ("stats", "plain", {"batch_records": BATCH}),
    ("stats_sorted", "sorted", {}),
])
def test_file_stats_equal_jax(cohorts, files, s, name, file, kwargs):
    want = jax_result("multihost_file_stats", files[file], **kwargs)
    assert _ok(cohorts[s], name) == [want] * s


@pytest.mark.parametrize("s", WORLDS)
@pytest.mark.parametrize("name,file,kwargs", [
    ("hist_spill", "plain", {"capacity": 64}),
    ("hist_sorted", "sorted", {}),
    ("hist_wide", "wide", {"capacity": 1024}),
    ("hist_strict_ok", "plain", {"capacity": 512, "spill": False}),
])
def test_histogram_equals_jax_on_every_rank(cohorts, files, s, name, file, kwargs):
    want = jax_result("multihost_barcode_histogram", files[file], batch_records=BATCH, **kwargs)
    assert _ok(cohorts[s], name) == [want] * s
    assert sum(want.values()) == N


@pytest.mark.parametrize("s", WORLDS)
def test_strict_capacity_raises_the_reference_text_on_every_rank(cohorts, files, s):
    """The sorted file gives each rank a contiguous range of fewer barcodes
    than the capacity, 300 over the cohort: the limit is the cohort's."""
    want = jax_result("multihost_barcode_histogram", files["sorted"], batch_records=BATCH,
                      capacity=CAPACITY, spill=False)
    assert str(want).startswith("300 distinct barcodes exceed the device table capacity=256")
    assert [got["hist_strict"] for got in cohorts[s]] == [("err", "ValueError", str(want))] * s


@pytest.mark.parametrize("s", WORLDS)
def test_a_given_merge_receives_the_states_stacked_by_rank(cohorts, files, s):
    want = jax_result("multihost_file_stats", files["plain"])
    for got in _ok(cohorts[s], "stacked"):
        assert got["count"].shape == (s,) and got["sums"].shape == (s, 3)
        assert int(got["count"].sum()) == want["count"] == N
        # rank r folded the reference partition's range r
        assert got["count"].tolist() == [N // s] * (s - 1) + [N - (s - 1) * (N // s)]


@pytest.mark.parametrize("s", WORLDS)
def test_the_state_tree_merges_in_one_collective(cohorts, s):
    assert _ok(cohorts[s], "collectives") == [{"collectives": 1, "count": N}] * s


@pytest.mark.parametrize("s", WORLDS)
def test_a_failed_update_raises_on_every_rank(cohorts, s):
    got = [res["update_fails"] for res in cohorts[s]]
    assert got[1] == ("err", "RuntimeError", "injected update failure")
    others = ("err", "ValueError", "multihost operation failed on another process "
              "during the state merge (see that rank's error)")
    assert [g for r, g in enumerate(got) if r != 1] == [others] * (s - 1)


@pytest.mark.parametrize("s", WORLDS)
def test_jax_per_shard_stats_states_seed_the_ranks(cohorts, files, s):
    states = jax.tree.map(np.asarray, jax_stats_states(files["plain"], s))
    want = JD.finalize_stats(JD.STATS_MAP_REDUCE.finalize(states))
    assert want == jax_result("multihost_file_stats", files["plain"])
    assert _ok(cohorts[s], "resume_stats") == [want] * s
    for shard in range(s):  # each shard's own count and sums carry across
        one = stats_state_from_jax(states, shard=shard)
        assert int(one["count"]) == int(states["count"][shard])


@pytest.mark.parametrize("s", WORLDS)
def test_a_jax_histogram_table_seeds_the_cohort(cohorts, files, s):
    """Shard 0 takes the JAX table, the other ranks an empty one; each rank
    then folds its range of a second file: the merge equals the JAX
    histogram continued over that file."""
    from ibu_tpu import MmapReader

    _, hist = jax_histogram_state(files["plain"])
    for batch in JD.record_batches_from_mmap(MmapReader(files["wide"]), BATCH):
        hist.update(batch)
    assert _ok(cohorts[s], "resume_hist") == [hist.finalize()] * s


@pytest.mark.parametrize("s", WORLDS)
@pytest.mark.parametrize("engine", ["mesh", "host", "auto"])
def test_sort_file_equals_native_sort_file(cohorts, files, native_sorted, s, engine):
    err = _ok(cohorts[s], f"sort_{engine}")
    got = (files["dir"] / f"w{s}" / f"{engine}.ibu").read_bytes()
    assert got == native_sorted["plain"]
    if engine == "auto":  # the CPU's choice, announced on every rank
        assert err == ["pod sort engine auto: cpu backend (no card): native external "
                       "sort -> host\n"] * s
    else:
        assert err == [""] * s


@pytest.mark.parametrize("s", WORLDS)
def test_the_operator_override_is_obeyed(cohorts, files, native_sorted, s):
    assert _ok(cohorts[s], "sort_env_host") == [
        "pod sort engine auto: operator override -> host\n"] * s
    assert (files["dir"] / f"w{s}" / "env.ibu").read_bytes() == native_sorted["wide"]


@pytest.mark.parametrize("s", WORLDS)
def test_the_engine_choice_is_cohort_uniform(cohorts, files, native_sorted, s):
    """Rank 1 has no native runtime: rank 0's preference (host) cannot run
    everywhere, so every rank runs the mesh sort, and says why."""
    got = _ok(cohorts[s], "agree")
    tail = ("; cohort agreement overrode local choice 'host' (rank-0 preference + "
            "every-rank native availability) -> mesh\n")
    assert got[0] == "pod sort engine auto: cpu backend (no card): native external sort" + tail
    assert got[1] == "pod sort engine auto: cpu backend but no native runtime -> mesh\n"
    assert (files["dir"] / f"w{s}" / "agree.ibu").read_bytes() == native_sorted["plain"]


@pytest.mark.parametrize("s", WORLDS)
def test_a_bad_override_raises_on_every_rank(cohorts, files, s):
    for r, got in enumerate(cohorts[s]):
        engine = "bogus" if r == 1 else "host"
        assert got["bad_env"] == ("err", "ValueError", "IBU_POD_SORT_ENGINE must be mesh or "
                                  f"host, got {engine!r} (on this or another rank)")
    assert not (files["dir"] / f"w{s}" / "bad.ibu").exists()


@pytest.mark.parametrize("s", WORLDS)
@pytest.mark.parametrize("name,stage", [("fail_runs", "the run sort"),
                                        ("fail_merge", "the merge write")])
def test_an_injected_failure_ends_every_rank(cohorts, files, s, name, stage):
    """Rank 1's native step raises: every rank raises (rank 1 its own error,
    the others the reference's pointer to it) within the launch's
    ``TIMEOUT``, and neither the output nor a run file is left behind."""
    got = [res[name] for res in cohorts[s]]
    assert got[1] == ("err", "OSError", "injected failure on rank 1")
    others = ("err", "ValueError", f"multihost operation failed on another process "
              f"during {stage} (see that rank's error)")
    assert [g for r, g in enumerate(got) if r != 1] == [others] * (s - 1)
    left = sorted(p.name for p in (files["dir"] / f"w{s}").iterdir()
                  if p.name.startswith(name))
    assert left == []


# ---------------------------------------------------------------------------
# in one process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("start,count,chunk", [(0, N, 0), (100, 2500, 700), (N, 0, 0),
                                               (5999, 1, 1)])
def test_sort_chunks_range_equals_the_reference(files, tmp_path, start, count, chunk):
    got = TN.sort_chunks_range(files["plain"], str(tmp_path / "t"), start, count,
                               chunk_records=chunk, nthreads=2)
    want = JN.sort_chunks_range(files["plain"], str(tmp_path / "j"), start, count,
                                chunk_records=chunk, nthreads=2)
    assert [p.replace("/t.", "/j.") for p in got] == want
    for g, w in zip(got, want):
        with open(g, "rb") as a, open(w, "rb") as b:
            assert a.read() == b.read()


@pytest.mark.parametrize("case", ["ragged", "past the end"])
def test_sort_chunks_range_refuses_like_the_reference(files, tmp_path, case):
    path = files["plain"]
    start, count = 0, N + 1
    if case == "ragged":
        path = str(tmp_path / "ragged.ibu")
        with open(files["plain"], "rb") as f, open(path, "wb") as g:
            g.write(f.read()[:-5])
        count = 10
    with pytest.raises(JInvalidMapSize) as want:
        JN.sort_chunks_range(path, str(tmp_path / "j"), start, count)
    with pytest.raises(InvalidMapSize) as got:
        TN.sort_chunks_range(path, str(tmp_path / "t"), start, count)
    assert str(got.value) == str(want.value)


def test_outside_a_cohort_the_engines_equal_jax(files, native_sorted, tmp_path, capsys):
    from ibu_tpu_torch.parallel import multihost as TMH

    assert TMH.process_count() == 1 and TMH.exchange_backend("cpu") is None
    assert TMH.multihost_file_stats(files["plain"], "cpu") == jax_result(
        "multihost_file_stats", files["plain"])
    assert TMH.multihost_barcode_histogram(files["wide"], "cpu", batch_records=BATCH,
                                           capacity=1024) == jax_result(
        "multihost_barcode_histogram", files["wide"], batch_records=BATCH, capacity=1024)
    for engine in ("mesh", "host", "auto"):
        TMH.multihost_sort_file(files["plain"], str(tmp_path / engine), "cpu", engine=engine)
        assert (tmp_path / engine).read_bytes() == native_sorted["plain"]
    assert capsys.readouterr().err == (
        "pod sort engine auto: cpu backend (no card): native external sort -> host\n")
