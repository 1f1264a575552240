"""The device-capacity labs of the port against the JAX package, on the CPU.

The engine, histogram, molecule-count and sort-keys labs build their inputs
from the reference tools' seeds; here their folds and calls run through the
plain torch versions at a small size and are held against ``ibu_tpu``'s
engines on the same numpy inputs (``STATS_MAP_REDUCE`` on the 8-device CPU
mesh, ``DeviceHistogram`` on one device, ``molecule_counts``,
``pair_molecule_counts`` and ``sort_records_soa``) and against numpy. Results
are integers: every comparison is exact (tolerance 0). Each lab's ``main``
runs with ``--device cpu`` and prints its JSON lines with every time null.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibu_tpu.ops import stats as JS
from ibu_tpu.ops.u64 import records_from_soa, soa_from_records
from ibu_tpu.parallel import device as JD
from ibu_tpu_torch.labs import _capacity as C
from ibu_tpu_torch.labs import engine_capacity_lab as EL
from ibu_tpu_torch.labs import histogram_capacity_lab as HL
from ibu_tpu_torch.labs import molcount_capacity_lab as ML
from ibu_tpu_torch.labs import sort_keys_lab as SL
from ibu_tpu_torch.ops import stats as TS
from ibu_tpu_torch.ops.u64 import records_from_tensor, records_to_tensor
from ibu_tpu_torch.parallel import device as TD

CPU = torch.device("cpu")
B = 4096
#: the keys every resident-batch lab prints (null on the CPU where timed)
RATE_KEYS = {"per_batch_ms", "issue_ms", "GB_s", "Mrec_s", "bound_ms", "pct_of_bound", "best_ms",
             "median_ms", "device", "timer"}


def jax_stats(hosts):
    mesh = JD.make_mesh()
    step = JD.STATS_MAP_REDUCE.compile_step(mesh)
    states = JD.STATS_MAP_REDUCE.initial_states(mesh)
    for h in hosts:
        states = step(states, *JD.shard_batch(h, mesh))
    return JD.finalize_stats(JD.STATS_MAP_REDUCE.finalize(states))


ENGINE_CASES = {
    "rng(13)": lambda: EL.make_buffers(B, 3),
    # every hi word all ones: each int64 sum wraps and every field sets bit 63
    "bit 63 everywhere": lambda: EL.make_buffers(B, 2) + [np.full((B, 6), 0xFFFFFFFF, np.uint32)],
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_fold_equals_jax_and_numpy(case):
    hosts = ENGINE_CASES[case]()
    hi = np.concatenate([h[:, 1::2] for h in hosts])
    assert (hi >> 31).any(), "a hi word sets bit 63"
    placed = C.place(hosts, CPU)
    state = EL.fold(TD.STATS_MAP_REDUCE.init(CPU), placed, len(hosts))
    got = TD.finalize_stats(TD.STATS_MAP_REDUCE.finalize(state))
    assert got == jax_stats(hosts) == EL.numpy_stats(hosts)
    assert got["count"] == len(hosts) * B


def test_engine_chain_cycles_the_buffers():
    hosts = EL.make_buffers(B, 3)
    state = EL.fold(TD.STATS_MAP_REDUCE.init(CPU), C.place(hosts, CPU), 5)
    cycled = hosts + hosts[:2]
    assert TD.finalize_stats(TD.STATS_MAP_REDUCE.finalize(state)) == EL.numpy_stats(cycled)


def test_engine_buffers_are_the_reference_draws():
    rng = np.random.default_rng(13)
    want = [rng.integers(0, 2**32, (64, 6), dtype=np.uint64).astype(np.uint32) for _ in range(2)]
    assert all(np.array_equal(a, b) for a, b in zip(EL.make_buffers(64, 2), want))


@pytest.fixture(scope="module")
def mesh1():
    """One JAX device: the JAX histogram's per-shard scope is then the batch."""
    return JD.make_mesh(jax.devices()[:1])


@pytest.mark.parametrize("spill", [True, False], ids=["spill on", "spill off"])
@pytest.mark.parametrize("bc16", [False, True], ids=["u64", "bc16"])
@pytest.mark.parametrize("sort", [False, True], ids=["unsorted", "sorted"])
def test_histogram_fold_equals_jax_and_numpy(mesh1, sort, bc16, spill):
    # spill on with a table smaller than the barcodes: the overflow lane runs
    capacity = 128 if spill else 512
    kwargs = dict(capacity=capacity, max_uniques_per_shard=512, merge_every=2, spill=spill,
                  assume_sorted=sort)
    hosts = HL.make_buffers(2048, 3, 300, sort)
    if sort:
        assert all(np.all(np.diff(h[:, 0]) >= 0) for h in hosts)
    got = HL.fold(TD.DeviceHistogram(device=CPU, **kwargs), C.place(hosts, CPU), 3,
                  bc16).finalize()
    jax_hist = JD.DeviceHistogram(mesh=mesh1, **kwargs)
    for h in hosts:
        jax_hist.update_placed(*JD.shard_batch(h, mesh1), bc16=bc16)
    want = HL.numpy_histogram(hosts)
    assert len(want) == 300 > capacity if spill else len(want) <= capacity
    assert got == jax_hist.finalize() == want


def test_histogram_buffers_are_the_reference_draws():
    rng = np.random.default_rng(17)
    raw = np.zeros((64, 6), dtype=np.uint32)
    raw[:, 0] = rng.integers(0, 4096, 64)
    raw[:, 2] = rng.integers(0, 1 << 16, 64)
    raw[:, 4] = rng.integers(0, 1 << 16, 64)
    assert np.array_equal(HL.make_buffers(64, 1, 4096, False)[0], raw)


@pytest.mark.parametrize("hints", [False, True], ids=["unhinted", "hinted"])
def test_molecule_counts_equal_jax_and_numpy(hints):
    batch = ML.make_batches(B, 2, 64, 16)[1]
    mol_kw, pair_kw = ML.hint_kwargs(hints)
    soa = jnp.asarray(soa_from_records(batch))
    t = records_to_tensor(batch, CPU)

    keys, mol, n = TS.molecule_counts(t, 128, **mol_kw)
    u_lo, u_hi, j_mol, j_n = JS.molecule_counts(soa, max_uniques=128, **mol_kw)
    jax_keys = np.asarray(u_lo).astype(np.uint64) | (np.asarray(u_hi).astype(np.uint64) << 32)
    assert np.array_equal(keys.numpy().view(np.uint64), jax_keys)
    assert np.array_equal(mol.numpy(), np.asarray(j_mol)) and int(n) == int(j_n) == 64
    assert TS.table_dict(keys, mol) == TS.molecule_counts_np(batch) == JS.molecule_counts_np(batch)

    pair_keys, counts, npairs = TS.pair_molecule_counts(t, 2048, **pair_kw)
    rows, j_counts, j_npairs = JS.pair_molecule_counts(soa, max_pairs=2048, **pair_kw)
    rows = np.asarray(rows).astype(np.uint64)
    assert np.array_equal(pair_keys.numpy().view(np.uint64),
                          np.stack([rows[0] | rows[1] << 32, rows[2] | rows[3] << 32], axis=1))
    assert np.array_equal(counts.numpy(), np.asarray(j_counts)) and int(npairs) == int(j_npairs)
    assert (TS.table_dict(pair_keys, counts) == TS.pair_molecule_counts_np(batch)
            == JS.pair_molecule_counts_np(batch))


def test_molcount_check_holds_and_catches_a_wrong_table():
    class Args:
        batch_records, max_uniques, max_pairs = B, 128, 2048

    batch = ML.make_batches(B, 1, 64, 16)[0]
    oracle = {"molecule_counts": TS.molecule_counts_np(batch),
              "pair_molecule_counts": TS.pair_molecule_counts_np(batch)}
    t = records_to_tensor(batch, CPU)
    for hints in (False, True):
        ML.check(ML.functions(Args, hints), t, oracle, hints)
    oracle["pair_molecule_counts"] = dict(list(oracle["pair_molecule_counts"].items())[1:])
    with pytest.raises(RuntimeError, match="pair_molecule_counts"):
        ML.check(ML.functions(Args, True), t, oracle, True)


def test_molcount_first_batch_is_the_reference_batch():
    rng = np.random.default_rng(23)
    bc = rng.integers(0, 2048, 100).astype(np.uint64)
    umi = rng.integers(0, 1 << 16, 100).astype(np.uint64)
    idx = rng.integers(0, 64, 100).astype(np.uint64)
    got = ML.make_batches(100, 2, 2048, 64)[0]
    assert [got[f].tolist() for f in ("barcode", "umi", "index")] == [
        bc.tolist(), umi.tolist(), idx.tolist()]


@pytest.mark.parametrize("variant", ["unhinted", "hinted"])
def test_sort_keys_equal_jax_sort_records_soa(variant):
    records = SL.make_records(20_000, SL.SEED0 + 1, CPU)
    host = records_from_tensor(records)
    hints = SL.HINTS if variant == "hinted" else {}
    want = records_from_soa(np.asarray(JS.sort_records_soa(jnp.asarray(soa_from_records(host)),
                                                           **hints)))
    got = records_from_tensor(SL.VARIANTS[variant][2](records))
    assert got.tobytes() == want.tobytes()
    assert got.tobytes() == np.sort(host, order=("barcode", "umi", "index")).tobytes()


def test_sort_keys_inputs_follow_the_reference_formula():
    n = 1000
    i = np.arange(n, dtype=np.uint32)
    x = (i * np.uint32(2654435761)) ^ (i >> np.uint32(3)) ^ np.uint32(1001)
    got = SL.make_records(n, 1001, CPU).numpy()
    assert np.array_equal(got[:, 0], x.astype(np.int64))
    umi = (x * np.uint32(40503)) & np.uint32(0xFFFFFF)
    assert np.array_equal(got[:, 1], umi.astype(np.int64))
    assert np.array_equal(got[:, 2], np.arange(n))
    SL.check([SL.make_records(n, 1001, CPU), SL.make_records(n // 2, 1002, CPU)])


def run_main(module, argv, capsys):
    assert module.main(argv) == 0
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


LAB_MAINS = {
    "engine": (EL, ["--batch-records", "2048", "--buffers", "3"], 1, {"best_s"}),
    "histogram": (HL, ["--batch-records", "2048", "--buffers", "3", "--max-uniques", "4096",
                       "--sorted", "--bc16"], 1, {"sort_ms", "sort_median_ms", "spill", "best_s"}),
    "molcount": (ML, ["--batch-records", "2048", "--buffers", "2", "--hints", "both"], 4,
                 {"kernel", "hints"}),
    "sort keys": (SL, ["--records", "1000", "3000", "--sets", "2"], 6,
                  {"variant", "operands", "hints", "ms_per_Mrec"}),
}


@pytest.mark.parametrize("lab", list(LAB_MAINS))
def test_lab_main_on_the_cpu_prints_its_lines(lab, capsys):
    module, argv, n_lines, keys = LAB_MAINS[lab]
    lines = run_main(module, argv + ["--device", "cpu"], capsys)
    assert len(lines) == n_lines
    for line in lines:
        assert RATE_KEYS | keys <= set(line)
        assert line["device"] == "cpu"
        assert all(line[k] is None for k in RATE_KEYS - {"device"})


class StubEvent:
    """Stands in for ``torch.cuda.Event``: ``record`` reads a clock and
    moves it 1 ms on (a timed step may move it further)."""

    clock = 0.0

    def __init__(self, enable_timing=False):
        self.at = None

    def record(self):
        self.at = StubEvent.clock
        StubEvent.clock += 1.0

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.at - self.at


@pytest.fixture
def stub_card(monkeypatch):
    """The labs' card path on CPU tensors: CUDA events, synchronisation and
    the sync debug mode stubbed. Returns the sync debug modes set."""
    modes = []
    monkeypatch.setattr(C, "on_card", lambda device: True)
    monkeypatch.setattr(C, "sync", lambda device: None)
    monkeypatch.setattr(C, "device_name", lambda device: "stub card")
    monkeypatch.setattr(torch.cuda, "Event", StubEvent)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    return modes


def test_chain_times_per_step(stub_card):
    prepared = []

    def prepare(k):
        prepared.append(k)

        def go():
            StubEvent.clock += 10.0 * k

        return go

    times = C.chain_times(prepare, (2, 8), 3, CPU, lambda: C.no_host_waits(CPU))
    assert prepared == [2] * 4 + [8] * 4  # one untimed chain, then three
    # each chain: 10 ms a step, and the start event's 1 ms
    assert times["best_ms"] == times["median_ms"] == {2: 10.5, 8: 10.125}
    assert times["issue_ms"][8] >= 0 and stub_card == ["error", "default"] * 8
    got = C.rates(times, 1 << 20, 24 << 20, 24 << 20, CPU)
    assert got["per_batch_ms"] == 10.125 and got["Mrec_s"] == (1 << 20) / 10125
    assert got["pct_of_bound"] == pytest.approx(100 * (24 << 20) / 3350e6 / 10.125)


@pytest.mark.parametrize("lab", list(LAB_MAINS))
def test_lab_main_on_a_stubbed_card_times_every_line(lab, stub_card, capsys):
    """The timed path of each resident-batch lab (CPU tensors, stubbed
    events): every rate is a number and the histogram chain runs under the
    sync debug mode."""
    module, argv, n_lines, keys = LAB_MAINS[lab]
    lines = run_main(module, argv + ["--device", "cpu", "--reps", "1"], capsys)
    assert len(lines) == n_lines
    for line in lines:
        assert RATE_KEYS | keys <= set(line)
        assert line["device"] == "stub card" and line["timer"].startswith("CUDA events")
        assert all(isinstance(line[k], float) for k in ("per_batch_ms", "bound_ms", "GB_s"))
    assert ("error" in stub_card) == (lab == "histogram")
