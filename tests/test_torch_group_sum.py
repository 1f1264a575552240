"""The histogram engine's group-by (``ibu_tpu_torch.ops.group_sum``) on the
CPU, where it runs its plain torch version: a batch's histogram against the
JAX package's ``_masked_histogram`` and a merge against its
``_sparse_group_sum_spill``, on the cases of ``tests/group_cases.py``, and
both against the torch chain the group-by replaced. Results are integers,
compared exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibu_tpu.parallel import device as JD
from ibu_tpu_torch.ops import group_sum as GS
from ibu_tpu_torch.ops import stats as TS
from tests import group_cases as GC

CPU = torch.device("cpu")


def u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def jax_words(lo, hi) -> np.ndarray:
    return np.asarray(lo).astype(np.uint64) | (np.asarray(hi).astype(np.uint64) << np.uint64(32))


def live_words(lo, hi, counts) -> np.ndarray:
    """The reference's slot keys where its count is not 0: past the valid
    groups it leaves the stale keys of empty entries under zero counts,
    where the port's tail is zeroed."""
    return np.where(np.asarray(counts) != 0, jax_words(lo, hi), np.uint64(0))


def lo_hi(keys: np.ndarray):
    k = keys.view(np.uint64)
    return (jnp.asarray((k & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            jnp.asarray((k >> np.uint64(32)).astype(np.uint32)))


@pytest.mark.parametrize("case", list(GC.BATCH_CASES))
def test_batch_histogram_matches_jax(case):
    make, cap, bc16 = GC.BATCH_CASES[case]
    records = make()
    raw = records.view(np.uint32).reshape(-1, 6)
    u_lo, u_hi, counts, n_uniq = JD._masked_histogram(
        jnp.asarray(raw), jnp.int32(len(records)), cap, bc16)
    t = torch.from_numpy(records)
    keys, got_counts, got_n = TS.barcode_histogram(t, cap, bc_len=16 if bc16 else None)
    assert np.array_equal(u64(keys), jax_words(u_lo, u_hi))
    assert np.array_equal(got_counts.numpy(), np.asarray(counts).astype(np.int64))
    assert int(got_n) == int(np.asarray(n_uniq)[0])
    old = GC.legacy_barcode_histogram(t, cap, bc16)
    assert all(torch.equal(a, b) for a, b in zip((keys, got_counts, got_n), old))


@pytest.mark.parametrize("case", list(GC.MERGE_CASES))
def test_merge_matches_jax(case):
    make, cap, lane = GC.MERGE_CASES[case]
    parts = make()
    keys = np.concatenate([k for k, _ in parts])
    weights = np.concatenate([c for _, c in parts]).astype(np.uint32)
    want = JD._sparse_group_sum_spill(*lo_hi(keys), jnp.asarray(weights), cap, lane)
    got = GC.merged(parts, cap, lane, CPU)
    table_k, table_c, n, lane_k, lane_c, lane_n = got
    assert np.array_equal(u64(table_k), live_words(want[0], want[1], want[2]))
    assert np.array_equal(table_c.numpy(), np.asarray(want[2]).astype(np.int64))
    assert int(n) == int(want[3])
    assert np.array_equal(u64(lane_k), live_words(want[4], want[5], want[6]))
    assert np.array_equal(lane_c.numpy(), np.asarray(want[6]).astype(np.int64))
    assert int(lane_n) == int(want[7])
    old = GC.legacy_merged(parts, cap, lane, CPU)
    assert all(torch.equal(a, b) for a, b in zip(got, old))


def test_merge_bound_needs_no_look_at_the_data():
    """The widest bound (64 key bits, 64 count bits: three key words) gives
    what the tight one does; so does the plain version called directly."""
    parts = GC.MERGE_CASES["w48"][0]()
    tight = GC.merged(parts, 4096, 5 * 1024, CPU)
    wide = GC.merged(parts, 4096, 5 * 1024, CPU, key_bits=64, count_bits=64)
    assert all(torch.equal(a, b) for a, b in zip(tight, wide))
    tensors = [tuple(GC.to(CPU, k, c)) for k, c in parts]
    plain = GS.plain_group_sum(tensors, 4096 + 5 * 1024)
    assert torch.equal(plain[0][:4096], tight[0]) and torch.equal(plain[1][4096:], tight[4])


def test_strided_keys_are_read_in_place():
    """A batch's barcode column is a view at a stride of 3 words, and a row
    view of a batch one of 6: both group as a contiguous copy does."""
    records = torch.from_numpy(GC.batch(22, 4001, 48, 300))
    for view in (records[:, 0], records[::2, 0]):
        assert view.stride(0) in (3, 6)
        got = GS.group_sum([(view, None)], 512)
        want = GS.group_sum([(view.contiguous(), None)], 512)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_plan_and_refusals():
    assert GS.plan(32, 0, False) == (1, 4)
    assert GS.plan(64, 0, False) == (1, 8)
    assert GS.plan(32, 24, True) == (1, 8)  # 57 bits: Drop-seq's merge bound
    assert GS.plan(64, 25, True) == (2, 12)  # 90 bits: SPLiT-seq's
    assert GS.plan(64, 64, True) == (3, 17)
    k = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="every part or in none"):
        GS.group_sum([(k, k), (k, None)], 4)
    with pytest.raises(ValueError, match="1-D torch.int64"):
        GS.group_sum([(k.to(torch.int32), None)], 4)
    with pytest.raises(ValueError, match="as long as their keys"):
        GS.group_sum([(k, k[:2])], 4)
    empty = torch.zeros(0, dtype=torch.int64)
    keys, sums, n = GS.group_sum([(empty, empty)], 3)
    assert keys.tolist() == sums.tolist() == [0, 0, 0] and int(n) == 0


def test_many_parts_are_joined():
    """More staged tables than one launch reads join into the last part;
    on the CPU the plain version takes them all at once."""
    parts = GC.merge(23, 24, 64, GS.MAX_PARTS + 5, 16, 500)
    tensors = [tuple(GC.to(CPU, k, c)) for k, c in parts]
    joined = GS._joined(tensors)
    assert len(joined) == GS.MAX_PARTS
    assert sum(k.shape[0] for k, _ in joined) == sum(k.shape[0] for k, _ in tensors)
    got = GS.group_sum(joined, 64 + 16 * (GS.MAX_PARTS + 5))
    want = GS.group_sum(tensors, 64 + 16 * (GS.MAX_PARTS + 5))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
