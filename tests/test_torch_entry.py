"""The port's entry points (``ibu_tpu_torch/entry.py``) against the
repository's ``__graft_entry__.py`` on the JAX CPU backend, exact.

``entry(device="cpu")``'s step on its example batch must give the records of
the reference step's ``(6, N)`` columns joined back, and the field sums of
its limb sums folded mod 2^64. ``dryrun_multichip`` runs cohorts of 2 and 3
Gloo ranks; a failure injected into one rank must end every rank nonzero
within the deadline, and a cohort that outlives its deadline is killed. The
command prints the reference's two lines.
"""

import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ibu_tpu.ops.codec import lax_encode_planes
from ibu_tpu.ops.stats import checksum_soa, fold_limbs
from ibu_tpu.ops.u64 import records_from_soa
from ibu_tpu_torch import entry as E
from ibu_tpu_torch.errors import NoCardError
from ibu_tpu_torch.ops.u64 import U64_MASK, records_from_tensor

REPO = Path(__file__).resolve().parents[1]


def _reference():
    spec = importlib.util.spec_from_file_location("graft_entry", REPO / "__graft_entry__.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REF = _reference()


@pytest.mark.parametrize("n, bc_len, umi_len", [(8192, 16, 12), (100, 1, 32), (7, 32, 1)])
def test_example_batch_is_the_references_transposed(n, bc_len, umi_len):
    bc_planes, umi_planes, idx_pair = REF._example_batch(n, bc_len, umi_len)
    bc_rows, umi_rows, index = E._example_batch(n, bc_len, umi_len)
    assert bc_rows.dtype == umi_rows.dtype == torch.uint8 and index.dtype == torch.int64
    assert np.array_equal(bc_rows.numpy(), bc_planes.T)
    assert np.array_equal(umi_rows.numpy(), umi_planes.T)
    assert np.array_equal(index.numpy(), idx_pair[0].astype(np.int64))
    assert not idx_pair[1].any()


def test_entry_step_equals_the_reference():
    jfn, jargs = REF.entry()
    soa, limbs = jfn(*jargs)
    fn, args = E.entry(device="cpu")
    assert all(t.device.type == "cpu" for t in args)
    records, sums = fn(*args)
    assert records.shape == (8192, 3) and records.dtype == torch.int64
    assert records_from_tensor(records).tobytes() == records_from_soa(np.asarray(soa)).tobytes()
    limbs = np.asarray(limbs)
    assert [int(s) & U64_MASK for s in sums.tolist()] == [fold_limbs(limbs[i]) for i in range(3)]


def test_entry_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCardError):
        E.entry()
    with pytest.raises(NoCardError):
        E.dryrun_multichip(2)


def test_dryrun_rank_in_a_world_of_one_equals_the_reference():
    got = E.dryrun_rank(0, 1, "cpu", records_per_rank=300)
    bc_planes, umi_planes, idx_pair = REF._example_batch(300)
    soa = np.concatenate([np.asarray(lax_encode_planes(bc_planes)),
                          np.asarray(lax_encode_planes(umi_planes)), idx_pair])
    sums = checksum_soa(soa)
    assert got == {"count": 300, "barcode_sum": sums[0], "umi_sum": sums[1],
                   "index_sum": sums[2], "all_reduced_count": 300, "sorted": 300}


@pytest.mark.parametrize("world", [2, 3])
def test_dryrun_multichip(world):
    E.dryrun_multichip(world, device="cpu")


RANK = """
import importlib, sys
from ibu_tpu_torch import entry
rank, module, name, store = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
if rank == int(sys.argv[5]):
    def boom(*args, **kwargs):
        raise OSError(f"injected failure on rank {rank}")
    setattr(importlib.import_module(module), name, boom)
sys.exit(entry.main(["--rank", str(rank), "--world", "2", "--store", store, "--device", "cpu"]))
"""


@pytest.mark.parametrize("module, name, failing", [
    ("ibu_tpu_torch.ops.codec_cuda", "encode_records", 1),
    ("ibu_tpu_torch.parallel.sort", "_local_sort", 0),
])
def test_a_failing_rank_ends_every_rank(tmp_path, module, name, failing):
    store = f"file://{tmp_path / 'store'}"
    procs = [subprocess.Popen([sys.executable, "-c", RANK, str(r), module, name, store,
                               str(failing)], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [1, 1], outs
    assert f"injected failure on rank {failing}" in outs[failing]
    assert "failed on another process" in outs[1 - failing]


def test_a_cohort_past_its_deadline_is_killed():
    with pytest.raises(RuntimeError, match=r"did not end within 0\.5 s"):
        E.dryrun_multichip(2, device="cpu", timeout=0.5)


def test_the_command_prints_the_references_lines():
    p = subprocess.run([sys.executable, "-m", "ibu_tpu_torch.entry", "--device", "cpu"],
                       cwd=REPO, capture_output=True, text=True, timeout=240)
    assert p.returncode == 0, p.stderr
    lines = p.stdout.splitlines()
    assert lines[0] == "entry OK: (((8192, 3), 'torch.int64'), ((3,), 'torch.int64'))"
    assert lines[-1] == "dryrun_multichip(2) OK"


def test_the_command_without_a_card_exits_2():
    code = ("import sys, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "from ibu_tpu_torch import entry\n"
            "sys.exit(entry.main([]))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 2
    assert p.stdout.startswith("python -m ibu_tpu_torch.entry: no CUDA card")
