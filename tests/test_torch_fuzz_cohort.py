"""Cohort failure-injection fuzz of the port, the counterpart of
``tests/test_fuzz_cohort.py``.

A real 2-rank Gloo cohort (:mod:`tests.torch_cohort`, ``device="cpu"``) runs
a random tool (dedup, filter, correct, count, the host sort or the mesh sort)
over a random file, with the same seeds (``7000 + seed``) and draws as the
reference's leg. On two thirds of the seeds one random rank's first write
fails (``multihost._pwrite_all``; ``native.merge_runs_interval`` for the host
sort), and then:

* no hang: every rank ends within the watchdog, or the launch fails;
* every rank exits nonzero;
* no output survives.

On the clean seeds the cohort's output equals, byte for byte, the port's
single-host tool and ``ibu_tpu``'s. Either way no ``.mh_count.part``,
``.mhsort`` or ``.mhingest`` file is left.

CI runs 4 seeds; set ``FUZZ_COHORT_SEEDS=N`` for an extended sweep.
"""

import os

import numpy as np
import pytest

from ibu_tpu_torch import Header, Writer, make_records
from tests.torch_cohort import launch_exits

TOOLS = ("dedup", "filter", "correct", "count", "sort-host", "sort-mesh")
WATCHDOG = 120  # seconds, as the reference's leg
COUNT_SUFFIXES = (".mtx", ".barcodes.txt", ".indices.txt")


def single_host(pkg: str, tool: str, in_path: str, out: str, allow: np.ndarray) -> None:
    """The single-host tool of ``pkg`` (``"torch"``: the port on the CPU;
    ``"jax"``: ``ibu_tpu`` on the JAX CPU backend)."""
    if pkg == "torch":
        from ibu_tpu_torch import native
        from ibu_tpu_torch import pipelines as P

        cpu = {"device": "cpu"}
    else:
        from ibu_tpu import native
        from ibu_tpu import pipelines as P

        cpu = {}
    if tool == "dedup":
        P.dedup_file(in_path, out, **cpu)
    elif tool == "filter":
        P.filter_file(in_path, out, allow)
    elif tool == "correct":
        P.correct_file(in_path, out, allow, **cpu)
    elif tool == "count":
        P.count_matrix(in_path, out)
    elif tool == "sort-host":
        native.sort_file(in_path, out)
    else:
        P.sort_file_device(in_path, out, **cpu)


def outputs(tool: str, out: str) -> list[str]:
    return [out + sfx for sfx in COUNT_SUFFIXES] if tool == "count" else [out]


@pytest.mark.parametrize("seed", range(int(os.environ.get("FUZZ_COHORT_SEEDS", 4))))
def test_cohort_failure_injection(seed, tmp_path):
    from ibu_tpu_torch import native

    rng = np.random.default_rng(7000 + seed)
    tool = TOOLS[int(rng.integers(0, len(TOOLS)))]
    if tool == "sort-host" and not native.available():
        tool = "sort-mesh"
    n = int(rng.integers(8_000, 40_000))
    presorted = bool(rng.integers(0, 2))
    bc = rng.integers(0, 300, n).astype(np.uint64)
    recs = make_records(bc, rng.integers(0, 50, n).astype(np.uint64),
                        rng.integers(0, 1 << 20, n).astype(np.uint64))
    h = Header.new(16, 12)
    if presorted:
        recs = np.sort(recs, order=("barcode", "umi", "index"))
        h.set_sorted()
    in_path = str(tmp_path / "in.ibu")
    with Writer.from_path(in_path, h) as w:
        w.write_batch(recs)
    allow = np.unique(rng.choice(bc, size=40))
    np.savetxt(in_path + ".allow", allow, fmt="%d")
    out = str(tmp_path / ("cnt" if tool == "count" else "out.ibu"))

    # a third of the seeds run clean; the rest fail a random rank's first write
    inject = int(rng.integers(0, 3)) != 0
    fail_rank = int(rng.integers(0, 2)) if inject else -1
    rng.integers(0, 2)  # the reference's fail_after draw (its workers inject at the first write)

    rcs, ranks = launch_exits(
        2, [("tool", "fuzz_tool", {"tool": tool, "in_path": in_path, "out": out,
                                   "allow_path": in_path + ".allow", "fail_rank": fail_rank})],
        tmp_path / "cohort", timeout=WATCHDOG)
    results = [r["tool"] for r in ranks]

    if not inject:
        assert rcs == [0, 0] and all(r[0] == "ok" for r in results), (tool, results)
        for pkg in ("torch", "jax"):
            single = str(tmp_path / f"{pkg}_single{'' if tool == 'count' else '.ibu'}")
            single_host(pkg, tool, in_path, single, allow)
            for got, want in zip(outputs(tool, out), outputs(tool, single)):
                assert open(got, "rb").read() == open(want, "rb").read(), (tool, pkg, got)
    else:
        assert all(rc != 0 for rc in rcs), (seed, tool, fail_rank, rcs, results)
        assert "injected ENOSPC" in results[fail_rank][2], results
        assert all(r[0] == "err" for r in results), results
        for path in outputs(tool, out):
            assert not os.path.exists(path), (tool, path)

    leftovers = [p.name for p in tmp_path.rglob("*")
                 if ".mh_count.part" in p.name or ".mhsort" in p.name or ".mhingest" in p.name]
    assert not leftovers, (tool, inject, leftovers)
