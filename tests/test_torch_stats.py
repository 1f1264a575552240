"""Field sums, the record sort and the stats stream against the JAX package,
on the CPU.

The JAX side runs ``field_sums_soa`` + ``fold_limbs``, ``sharded_stats`` and
``stream_file_stats`` on the 8-device CPU mesh, and ``sort_records_soa``; the
port runs its torch versions on the same seeded records. Every comparison is
exact (tolerance 0): the results are integers.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibu_tpu import Header, MmapReader, Writer
from ibu_tpu.constructs.record import RECORD_DTYPE, make_records
from ibu_tpu.ops import stats as JS
from ibu_tpu.ops.u64 import records_from_soa, soa_from_records
from ibu_tpu.parallel import device as JD
from ibu_tpu_torch.ops import sort_cuda as SC
from ibu_tpu_torch.ops import stats as TS
from ibu_tpu_torch.ops.u64 import (
    jax_soa_from_records,
    records_from_tensor,
    records_to_tensor,
    stats_state_from_jax,
)
from ibu_tpu_torch.parallel import device as TD

FIXTURES = Path(__file__).parent / "fixtures"
CPU = torch.device("cpu")


def random_records(n, seed, bc_bits=64, umi_bits=64, index_bits=64, dup=False):
    """Seeded records; ``*_bits`` bound each field, ``dup`` draws from a
    small pool so that ties on every key occur."""
    rng = np.random.default_rng(seed)

    def col(bits):
        hi = 1 << bits
        vals = rng.integers(0, hi, size=n, dtype=np.uint64)
        if dup:
            pool = rng.integers(0, hi, size=7, dtype=np.uint64)
            vals = pool[rng.integers(0, 7, size=n)]
        return vals

    return make_records(col(bc_bits), col(umi_bits), col(index_bits))


def jax_sums(records) -> tuple[int, int, int]:
    limbs = np.asarray(JS.field_sums_soa(jnp.asarray(soa_from_records(records))))
    return tuple(JS.fold_limbs(limbs[f]) for f in range(3))


def all_ones(n):
    return np.full(n, (1 << 64) - 1, dtype=np.uint64)


SUM_CASES = {
    "random": lambda: random_records(1001, seed=1),
    "umax_fixture": lambda: np.asarray(MmapReader(str(FIXTURES / "umax.ibu")).records).copy(),
    "wrapping": lambda: make_records(all_ones(777), all_ones(777), all_ones(777)),
    "empty": lambda: np.zeros(0, dtype=RECORD_DTYPE),
}


@pytest.mark.parametrize("case", list(SUM_CASES))
def test_field_sums_match(case):
    records = SUM_CASES[case]()
    got = TS.checksum_records(records_to_tensor(records, CPU))
    assert got == jax_sums(records)
    assert got == JS.checksum_records_np(records)


@pytest.mark.parametrize("case", list(SUM_CASES))
def test_sharded_stats_match_mesh(case):
    records = SUM_CASES[case]()
    want = JD.sharded_stats(soa_from_records(records))
    assert TD.sharded_stats(records, device=CPU) == want


def test_wrapping_sum_is_mod_2_64():
    n = 777
    got = TS.checksum_records(
        records_to_tensor(make_records(all_ones(n), all_ones(n), all_ones(n)), CPU)
    )
    assert got == ((n * ((1 << 64) - 1)) & ((1 << 64) - 1),) * 3


#: the Drop-seq chemistry's hints: 12-base barcodes, 8-base UMIs, 32-bit index
DROPSEQ_HINTS = {"bc_len": 12, "umi_len": 8, "index_bits": 32}
SORT_HINTS = [
    {},
    {"bc_len": 16, "umi_len": 12},
    {"bc_len": 16, "umi_len": 12, "index_bits": 32},
    {"bc_len": 20, "umi_len": 10, "index_bits": 32},
    {"bc_len": 32, "umi_len": 32},
    {"index_bits": 32},
]


@pytest.mark.parametrize("hints", SORT_HINTS, ids=lambda h: str(sorted(h.items())))
@pytest.mark.parametrize("dup", [False, True])
def test_sort_matches_jax(hints, dup):
    bits = {
        "bc_bits": 32 if hints.get("bc_len", 32) <= 16 else 64,
        "umi_bits": 32 if hints.get("umi_len", 32) <= 16 else 64,
        "index_bits": 32 if hints.get("index_bits", 64) <= 32 else 64,
    }
    records = random_records(517, seed=11, dup=dup, **bits)
    want = records_from_soa(
        np.asarray(JS.sort_records_soa(jnp.asarray(soa_from_records(records)), **hints))
    )
    got = records_from_tensor(TS.sort_records(records_to_tensor(records, CPU), **hints))
    assert got.tobytes() == want.tobytes()
    assert got.tobytes() == np.sort(records, order=("barcode", "umi", "index")).tobytes()


def test_sort_unsigned_order_at_bit63():
    records = make_records(
        np.array([1 << 63, 1, (1 << 64) - 1, 0], dtype=np.uint64),
        np.zeros(4, dtype=np.uint64),
        np.array([(1 << 64) - 1, 0, 1 << 63, 5], dtype=np.uint64),
    )
    got = records_from_tensor(TS.sort_records(records_to_tensor(records, CPU)))
    assert got["barcode"].tolist() == [0, 1, 1 << 63, (1 << 64) - 1]


@pytest.mark.parametrize(
    "hints", [{"bc_len": 16, "umi_len": 12}, {"umi_len": 12, "index_bits": 32},
              {"index_bits": 32}, DROPSEQ_HINTS]
)
def test_sort_hint_violation_message_matches(hints):
    """``umax.ibu``'s all-ones record breaks its own bc16/umi12 header."""
    records = np.asarray(MmapReader(str(FIXTURES / "umax.ibu")).records).copy()
    with pytest.raises(ValueError) as jax_err:
        JS.sort_records_soa(jnp.asarray(soa_from_records(records)), **hints)
    with pytest.raises(ValueError) as torch_err:
        TS.sort_records(records_to_tensor(records, CPU), **hints)
    assert str(torch_err.value) == str(jax_err.value)
    assert str(torch_err.value).startswith("sort hint violated: ")


def test_unchecked_hint_zeroes_dropped_words_like_jax():
    records = random_records(300, seed=5, dup=True)
    hints = {"bc_len": 16, "umi_len": 12, "index_bits": 32, "check": False}
    want = records_from_soa(
        np.asarray(JS.sort_records_soa(jnp.asarray(soa_from_records(records)), **hints))
    )
    got = records_from_tensor(TS.sort_records(records_to_tensor(records, CPU), **hints))
    assert got.tobytes() == want.tobytes()


def width_records(n, seed, bits, dup=False):
    """Seeded records whose fields hold exactly ``bits`` bits: values below
    2^b, one row with bit b - 1 set (bit 63 where b = 64)."""
    rng = np.random.default_rng(seed)
    cols = []
    for b in bits:
        vals = rng.integers(0, 1 << b, size=n, dtype=np.uint64) if b else np.zeros(n, np.uint64)
        if dup:
            vals = vals[rng.integers(0, min(n, 5), size=n)]
        if b and n:
            vals[rng.integers(0, n)] |= np.uint64(1 << (b - 1))
        cols.append(vals)
    return make_records(*cols)


def every_second_row(records):
    """``records`` to be sorted as the strided view ``t[::2]`` of their tensor."""
    return records, 2


def case_tensor(made, device):
    """``(numpy records, the tensor sort_records gets)`` of a case: a
    ``(records, step)`` pair gives the row view ``t[::step]``."""
    records, step = made if isinstance(made, tuple) else (made, 1)
    return records[::step], records_to_tensor(records, device)[::step]


#: name → (records, hints, key bits W); W = 0 ... 192 around the word edges,
#: bit 63 in each field, ties, tiny batches, a hint that drops set bits, and
#: a strided row view
KEY_CASES = {
    "W0": (lambda: width_records(300, 1, (0, 0, 0)), {}, 0),
    "W56": (lambda: width_records(3000, 2, (24, 16, 16), dup=True), DROPSEQ_HINTS, 56),
    "W63": (lambda: width_records(3000, 3, (24, 16, 23)), DROPSEQ_HINTS, 63),
    "W64": (lambda: width_records(3000, 4, (32, 16, 16)), DROPSEQ_HINTS, 64),
    "W65": (lambda: width_records(3000, 5, (33, 16, 16)), {"umi_len": 8, "index_bits": 32}, 65),
    "W128": (lambda: width_records(3000, 6, (64, 32, 32)), {"umi_len": 16, "index_bits": 32}, 128),
    "W129": (lambda: width_records(3000, 7, (64, 33, 32)), {"index_bits": 32}, 129),
    "W192": (lambda: width_records(3000, 8, (64, 64, 64), dup=True), {}, 192),
    "bit63_barcode": (lambda: width_records(999, 9, (64, 5, 5)), {}, 74),
    "bit63_umi": (lambda: width_records(999, 10, (5, 64, 5)), {}, 74),
    "bit63_index": (lambda: width_records(999, 11, (5, 5, 64)), {}, 74),
    "equal_rows": (lambda: make_records(*(np.full(257, v, np.uint64) for v in (5, 1 << 63, 9))),
                   {}, 3 + 64 + 4),
    "n0": (lambda: width_records(0, 12, (24, 16, 16)), DROPSEQ_HINTS, 0),
    "n1": (lambda: width_records(1, 13, (24, 16, 16)), DROPSEQ_HINTS, 56),
    "n2": (lambda: make_records(*(np.array(v, np.uint64) for v in ([7, 3], [1, 2], [0, 0]))),
           {}, 3 + 2 + 0),
    "unchecked_hi_bits": (lambda: width_records(2000, 14, (64, 64, 64), dup=True),
                          {**DROPSEQ_HINTS, "check": False}, 96),
    "strided_view": (lambda: every_second_row(width_records(3000, 15, (24, 16, 16))),
                     DROPSEQ_HINTS, 56),
}


@pytest.mark.parametrize("case", list(KEY_CASES))
def test_compacted_key_sort_matches_jax_and_numpy(case):
    """The plain compacted-key sort (the CPU's route through ``sort_records``)
    against the JAX package and ``np.sort``; an unchecked hint's dropped hi
    words come back as zeros."""
    make, hints, bits = KEY_CASES[case]
    records, t = case_tensor(make(), CPU)
    hi_used = (hints.get("bc_len", 32) > 16, hints.get("umi_len", 32) > 16,
               hints.get("index_bits", 64) > 32)
    ors = SC.plain_field_ors(t).tolist()
    assert sum(SC.key_widths(ors, hi_used)) == bits
    masked = records.copy()
    for f, name in enumerate(("barcode", "umi", "index")):
        if not hi_used[f]:
            masked[name] &= np.uint64(0xFFFFFFFF)
    want = np.sort(masked, order=("barcode", "umi", "index"))
    got = records_from_tensor(TS.sort_records(t, **hints))
    assert got.tobytes() == want.tobytes()
    exact = SC.plain_sort_records(t, hi_used, widths=SC.key_widths(ors, hi_used))
    assert records_from_tensor(exact).tobytes() == want.tobytes()
    if len(records):
        jax_want = records_from_soa(
            np.asarray(JS.sort_records_soa(jnp.asarray(soa_from_records(records)), **hints))
        )
        assert got.tobytes() == jax_want.tobytes()


@pytest.mark.parametrize("widths, words, passes", [
    ((0, 0, 0), 0, 0), ((24, 16, 16), 1, 7), ((24, 16, 23), 1, 8), ((32, 16, 16), 1, 8),
    ((33, 16, 16), 2, 9), ((32, 24, 16), 2, 9), ((64, 32, 32), 2, 16), ((64, 33, 32), 3, 17),
    ((64, 64, 64), 3, 24), ((1, 0, 0), 1, 1),
])
def test_sort_plan_of_the_widths(widths, words, passes):
    assert SC.plan(widths) == (words, passes)


def test_key_widths_masks_and_bounds():
    ors = [-1, 0x1_0000_0001, 0]  # bit 63 set (int64 bits), bit 32, nothing
    assert SC.key_widths(ors, (True, True, True)) == (64, 33, 0)
    assert SC.key_widths(ors, (False, False, False)) == (32, 1, 0)
    assert SC.bound_widths((False, True, False)) == (32, 64, 32)
    hints = SC.Hints((False, True, False))
    assert hints == (False, True, False) and hints.ors is None and hints.widths is None
    assert SC.launch_widths(hints) == (32, 64, 32)
    assert SC.launch_widths(SC.Hints(hints, widths=(3, 40, 0))) == (3, 40, 0)


def test_sort_impl_takes_a_plain_tuple_of_flags():
    """``_sort_impl(records, hi_used)`` sorts given three flags alone, as
    given :func:`sort_records`' hints."""
    records = width_records(500, 16, (40, 20, 36))
    t = records_to_tensor(records, CPU)
    want = np.sort(records, order=("barcode", "umi", "index"))
    for hi_used in ((True, True, True), SC.Hints((True, True, True))):
        assert records_from_tensor(TS._sort_impl(t, hi_used)).tobytes() == want.tobytes()


def test_soa_converters_roundtrip():
    records = random_records(129, seed=3)
    t = records_to_tensor(records, CPU)
    soa = jax_soa_from_records(t)
    assert np.array_equal(soa, soa_from_records(records))
    from ibu_tpu_torch.ops.u64 import records_from_jax_soa

    assert torch.equal(records_from_jax_soa(soa), t)


def write_file(tmp_path, records, name="s.ibu"):
    path = str(tmp_path / name)
    with Writer.from_path(path, Header.new(16, 12)) as w:
        w.write_batch(records)
    return path


@pytest.mark.parametrize("batch_records", [64, 100, 1000, 5000])
def test_stream_file_stats_matches_jax(tmp_path, batch_records):
    records = random_records(1000 + 37, seed=21)  # ragged last batch
    path = write_file(tmp_path, records)
    want = JD.stream_file_stats(MmapReader(path), batch_records=batch_records)
    got = TD.stream_file_stats(MmapReader(path), device=CPU, batch_records=batch_records)
    assert got == want
    assert (got["barcode_sum"], got["umi_sum"], got["index_sum"]) == (
        JS.checksum_records_np(records)
    )


def test_state_carried_across_from_jax():
    """First half of the batches in JAX, the state converted, second half in
    the port: equal to the whole run on either side."""
    batches = [random_records(n, seed=40 + i) for i, n in enumerate([256, 129, 512, 77])]
    mesh = JD.make_mesh()
    step = JD.STATS_MAP_REDUCE.compile_step(mesh)
    states = JD.STATS_MAP_REDUCE.initial_states(mesh)
    for batch in batches[:2]:
        states = step(states, *JD.shard_batch(batch, mesh))
    carried = stats_state_from_jax(JD.STATS_MAP_REDUCE.finalize(states))
    got = TD.finalize_stats(
        TD.STATS_MAP_REDUCE.run(iter(batches[2:]), device=CPU, state=carried)
    )
    want = JD.finalize_stats(JD.STATS_MAP_REDUCE.run(iter(batches)))
    assert got == want
    assert got == TD.finalize_stats(TD.STATS_MAP_REDUCE.run(iter(batches), device=CPU))
