"""The histogram stack of the port against the JAX package's, on the CPU.

``ibu_tpu_torch.ops.stats`` (barcode histogram, molecule counts, pair
molecule counts) against ``ibu_tpu.ops.stats``; the engines of
``ibu_tpu_torch.parallel.device`` (``DeviceHistogram``,
``sharded_barcode_histogram``, ``stream_file_histogram``) against
``ibu_tpu.parallel.device`` on a one-device mesh (one card is one shard, so
the per-shard limits and order checks cover the same records); and
``pipelines.barcode_counts`` and the gzip stream against ``ibu_tpu.pipelines``.
The same seeded numpy records go to both sides. Results are integers and
error texts, compared exactly (tolerance 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibu_tpu import Header, MmapReader, Reader, Writer
from ibu_tpu import pipelines as JPL
from ibu_tpu.constructs.record import make_records, sort_records
from ibu_tpu.ops import stats as JS
from ibu_tpu.ops.u64 import soa_from_records
from ibu_tpu.parallel import device as JD
from ibu_tpu_torch import pipelines as TPL
from ibu_tpu_torch.ops import stats as TS
from ibu_tpu_torch.ops.u64 import histogram_state_from_jax, records_to_tensor, wire_view
from ibu_tpu_torch.parallel import device as TD
from tests.test_torch_cli import port_text

CPU = torch.device("cpu")
U64_MAX = (1 << 64) - 1
N = 1000


@pytest.fixture(scope="module")
def mesh1():
    """One JAX device: the JAX engines' per-shard scope is then the batch."""
    return JD.make_mesh(jax.devices()[:1])


def pooled_records(n, seed, pool_size, bits=64, extremes=True):
    """Records whose barcodes come from a seeded pool of ``pool_size``
    values below ``2**bits``; with ``extremes`` the pool holds barcode 0 and
    the u64 maximum (which must not merge with padding or empty slots)."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 1 << bits, pool_size, dtype=np.uint64)
    if extremes:
        pool[:2] = (0, U64_MAX)
    return make_records(
        pool[rng.integers(0, pool_size, n)],
        rng.integers(0, 64, n, dtype=np.uint64),
        rng.integers(0, 1 << 64, n, dtype=np.uint64),
    )


def jax_words(lo, hi) -> np.ndarray:
    return np.asarray(lo).astype(np.uint64) | (np.asarray(hi).astype(np.uint64) << np.uint64(32))


def port_words(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


# ---------------------------------------------------------------------------
# ops: grouped aggregations against ibu_tpu.ops.stats
# ---------------------------------------------------------------------------

AGG_CASES = {
    # name: (records, max_uniques, hints)
    "u64": (lambda: pooled_records(N, 1, 150), 1024, {}),
    "u64 overflow": (lambda: pooled_records(N, 2, 150), 16, {}),
    "bc16 hint": (lambda: pooled_records(N, 3, 150, bits=32, extremes=False), 1024,
                  {"bc_len": 16, "umi_len": 12}),
    # hi words set under a <=16-base hint: both sides mis-group the same way
    "violated hint": (lambda: pooled_records(N, 4, 150), 1024, {"bc_len": 16, "umi_len": 12}),
}


@pytest.mark.parametrize("case", list(AGG_CASES))
def test_barcode_histogram_matches_jax(case):
    make, cap, hints = AGG_CASES[case]
    records = make()
    u_lo, u_hi, counts, n_uniq = JS.barcode_histogram(
        jnp.asarray(soa_from_records(records)), max_uniques=cap, bc_len=hints.get("bc_len")
    )
    keys, got_counts, got_n = TS.barcode_histogram(
        records_to_tensor(records, CPU), cap, bc_len=hints.get("bc_len")
    )
    assert np.array_equal(port_words(keys), jax_words(u_lo, u_hi))
    assert np.array_equal(got_counts.numpy(), np.asarray(counts))
    assert int(got_n) == int(n_uniq)
    if case == "u64":
        assert TS.table_dict(keys, got_counts) == TS.barcode_histogram_np(records)
        assert TS.barcode_histogram_np(records) == JS.barcode_histogram_np(records)


@pytest.mark.parametrize("case", list(AGG_CASES))
def test_molecule_counts_match_jax(case):
    make, cap, hints = AGG_CASES[case]
    records = make()
    u_lo, u_hi, mol, n_uniq = JS.molecule_counts(
        jnp.asarray(soa_from_records(records)), max_uniques=cap, **hints
    )
    keys, got_mol, got_n = TS.molecule_counts(records_to_tensor(records, CPU), cap, **hints)
    assert np.array_equal(port_words(keys), jax_words(u_lo, u_hi))
    assert np.array_equal(got_mol.numpy(), np.asarray(mol))
    assert int(got_n) == int(n_uniq)
    if case == "u64":
        assert TS.table_dict(keys, got_mol) == TS.molecule_counts_np(records)
        assert TS.molecule_counts_np(records) == JS.molecule_counts_np(records)


PAIR_CASES = {
    "u64": ({}, 8192),
    "overflow": ({}, 64),
    "hinted": ({"bc_len": 16, "umi_len": 12, "index_bits": 32}, 8192),
}


@pytest.mark.parametrize("case", list(PAIR_CASES))
def test_pair_molecule_counts_match_jax(case):
    hints, cap = PAIR_CASES[case]
    bits = 32 if hints else 64
    rng = np.random.default_rng(5)
    bpool = rng.integers(0, 1 << bits, 60, dtype=np.uint64)
    ipool = rng.integers(0, 1 << bits, 20, dtype=np.uint64)
    if not hints:
        bpool[:2] = (0, U64_MAX)
        ipool[:2] = (0, U64_MAX)
    records = make_records(
        bpool[rng.integers(0, 60, N)],
        rng.integers(0, 8, N, dtype=np.uint64),
        ipool[rng.integers(0, 20, N)],
    )
    rows, counts, n_pairs = JS.pair_molecule_counts(
        jnp.asarray(soa_from_records(records)), max_pairs=cap, **hints
    )
    rows = np.asarray(rows)
    keys, got_counts, got_n = TS.pair_molecule_counts(records_to_tensor(records, CPU), cap, **hints)
    assert np.array_equal(port_words(keys[:, 0].contiguous()), jax_words(rows[0], rows[1]))
    assert np.array_equal(port_words(keys[:, 1].contiguous()), jax_words(rows[2], rows[3]))
    assert np.array_equal(got_counts.numpy(), np.asarray(counts))
    assert int(got_n) == int(n_pairs)
    if case == "u64":
        assert TS.table_dict(keys, got_counts) == TS.pair_molecule_counts_np(records)
        assert TS.pair_molecule_counts_np(records) == JS.pair_molecule_counts_np(records)


def test_empty_aggregations():
    empty = torch.zeros((0, 3), dtype=torch.int64)
    for fn, cap in ((TS.barcode_histogram, 8), (TS.molecule_counts, 8)):
        keys, counts, n = fn(empty, cap)
        assert keys.shape == counts.shape == (cap,) and int(n) == 0 and not counts.any()
    keys, counts, n = TS.pair_molecule_counts(empty, 8)
    assert keys.shape == (8, 2) and int(n) == 0


def test_checksum_oracle_matches_jax():
    records = pooled_records(N, 6, 50)
    assert TS.checksum_records_np(records) == JS.checksum_records_np(records)


# ---------------------------------------------------------------------------
# engines against ibu_tpu.parallel.device on a one-device mesh
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stream_records():
    """6000 records over 500 barcodes (0 and the u64 maximum among them), in
    7 ragged batches."""
    records = pooled_records(6000, 7, 500)
    return records, np.array_split(records, 7)


ENGINE_CASES = [
    # (merge_every, spill, capacity)
    (1, True, 128),
    (3, True, 128),
    (16, True, 128),
    (3, False, 1024),
    (16, False, 1024),
]


@pytest.mark.parametrize("merge_every,spill,capacity", ENGINE_CASES)
def test_device_histogram_matches_jax(mesh1, stream_records, merge_every, spill, capacity):
    records, batches = stream_records
    kw = dict(capacity=capacity, max_uniques_per_shard=1024, merge_every=merge_every, spill=spill)
    want = JD.DeviceHistogram(mesh=mesh1, **kw).run(iter(batches))
    h = TD.DeviceHistogram(device=CPU, **kw)
    got = h.run(iter(batches))
    assert got == want == TS.barcode_histogram_np(records)
    assert {0, U64_MAX} <= set(got)
    assert bool(h._spilled) == spill  # 500 barcodes overflow the 128-slot table


def test_device_histogram_sorted_matches_jax(mesh1, stream_records):
    records, _ = stream_records
    batches = np.array_split(sort_records(records), 5)
    kw = dict(capacity=1024, max_uniques_per_shard=1024, merge_every=3, assume_sorted=True)
    want = JD.DeviceHistogram(mesh=mesh1, **kw).run(iter(batches))
    assert TD.DeviceHistogram(device=CPU, **kw).run(iter(batches)) == want
    # a decrease between batches is harmless: merging is by key
    backwards = batches[::-1]
    want = JD.DeviceHistogram(mesh=mesh1, **kw).run(iter(backwards))
    assert TD.DeviceHistogram(device=CPU, **kw).run(iter(backwards)) == want


def overflow_text(jax_text: str) -> str:
    """The reference's error text as the port words it: a shard overflow
    (``a shard saw N unique barcodes, ...``) names the least power of two
    that holds the N barcodes as the cap to raise to; other texts are the
    same."""
    if not jax_text.startswith("a shard saw "):
        return jax_text
    seen = int(jax_text.split()[3])
    fit = f"raise the cap to {1 << (seen - 1).bit_length()} (the CLI's --max-uniques)"
    return jax_text.replace("raise the cap", fit)


def jax_and_port_errors(mesh1, kw, batches):
    """Both engines fed ``batches``; the ``ValueError`` texts they raise."""
    texts = []
    for h in (JD.DeviceHistogram(mesh=mesh1, **kw), TD.DeviceHistogram(device=CPU, **kw)):
        for b in batches:
            h.update(b)
        with pytest.raises(ValueError) as err:
            h.finalize()
        texts.append(str(err.value))
    return texts


@pytest.mark.parametrize("where", ["lo word", "hi word", "bit 63"])
def test_lying_sorted_flag_error_matches_jax(mesh1, where):
    bc = np.arange(64, dtype=np.uint64)
    if where == "hi word":
        bc = (bc << np.uint64(32)) | np.uint64(7)
    elif where == "bit 63":  # unsigned order: bit 63 set sorts last
        bc = bc | np.uint64(1 << 63)
    bc[20], bc[21] = bc[21], bc[20]
    records = make_records(bc, np.zeros(64, np.uint64), np.arange(64, dtype=np.uint64))
    kw = dict(capacity=128, max_uniques_per_shard=64, assume_sorted=True)
    jax_text, port_text = jax_and_port_errors(mesh1, kw, [records])
    assert port_text == jax_text and "sorted" in port_text


def test_sorted_path_uses_unsigned_order():
    """Barcodes with bit 63 set after smaller ones are in order (unsigned)."""
    bc = np.array([1, 5, 1 << 63, U64_MAX, U64_MAX], dtype=np.uint64)
    records = make_records(bc, np.zeros(5, np.uint64), np.arange(5, dtype=np.uint64))
    h = TD.DeviceHistogram(capacity=16, max_uniques_per_shard=16, assume_sorted=True, device=CPU)
    assert h.run(iter([records])) == {1: 1, 5: 1, 1 << 63: 1, U64_MAX: 2}


def test_capacity_and_shard_overflow_errors_match_jax(mesh1):
    records = pooled_records(4096, 8, 4096, extremes=False)
    kw = dict(capacity=128, max_uniques_per_shard=4096, spill=False)
    jax_text, port_text = jax_and_port_errors(mesh1, kw, [records])
    assert port_text == jax_text and "device table" in port_text
    kw = dict(capacity=1 << 14, max_uniques_per_shard=64)
    jax_text, port_text = jax_and_port_errors(mesh1, kw, [records])
    assert port_text == overflow_text(jax_text) and "unique barcodes" in port_text
    with pytest.raises(ValueError) as jax_err:
        JD.DeviceHistogram(mesh=mesh1, capacity=64, merge_every=0)
    with pytest.raises(ValueError) as port_err:
        TD.DeviceHistogram(capacity=64, merge_every=0, device=CPU)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("sorted_in", [False, True])
def test_sharded_histogram_matches_jax(mesh1, stream_records, sorted_in):
    records, batches = stream_records
    if sorted_in:
        batches = np.array_split(sort_records(records), 4)
    want = JD.sharded_barcode_histogram(
        iter(batches), mesh=mesh1, max_uniques_per_shard=1024, sorted_in=sorted_in
    )
    got = TD.sharded_barcode_histogram(
        iter(batches), device=CPU, max_uniques_per_shard=1024, sorted_in=sorted_in
    )
    assert got == want == TS.barcode_histogram_np(records)


def test_sharded_histogram_errors_match_jax(mesh1, stream_records):
    records, _ = stream_records
    for kw, batches in (
        ({"max_uniques_per_shard": 64}, [records]),
        ({"max_uniques_per_shard": 1024, "sorted_in": True}, [records]),
    ):
        with pytest.raises(ValueError) as jax_err:
            JD.sharded_barcode_histogram(iter(batches), mesh=mesh1, **kw)
        with pytest.raises(ValueError) as port_err:
            TD.sharded_barcode_histogram(iter(batches), device=CPU, **kw)
        assert str(port_err.value) == overflow_text(str(jax_err.value))


def test_bc16_hint_matches_jax():
    small = pooled_records(100, 9, 10, bits=32, extremes=False)
    full = pooled_records(100, 9, 10)
    for records in (small, full, small[:0]):
        assert TD.bc16_hint(wire_view(records)) == JD.bc16_hint(JD.as_raw_u32(records))


# ---------------------------------------------------------------------------
# files: stream_file_histogram, barcode_counts, gzip
# ---------------------------------------------------------------------------


def write(tmp_path, name, records, sorted_flag=False, compression=None):
    header = Header.new(16, 12)
    if sorted_flag:
        header.set_sorted()
    path = str(tmp_path / name)
    with Writer.from_path(path, header, compression=compression) as w:
        w.write_batch(records)
    return path


@pytest.mark.parametrize("sorted_file", [False, True])
def test_stream_file_histogram_matches_jax(mesh1, tmp_path, stream_records, sorted_file):
    records, _ = stream_records
    if sorted_file:
        records = sort_records(records)
    path = write(tmp_path, "s.ibu", records, sorted_flag=sorted_file)
    kw = dict(batch_records=1000, capacity=256, max_uniques_per_shard=1024)
    want = JD.stream_file_histogram(MmapReader(path), mesh=mesh1, **kw)
    got = TD.stream_file_histogram(MmapReader(path), device=CPU, **kw)
    assert got == want == TS.barcode_histogram_np(records)


def test_stream_file_histogram_lying_header_matches_jax(mesh1, tmp_path, stream_records):
    records, _ = stream_records
    path = write(tmp_path, "lie.ibu", records, sorted_flag=True)
    with pytest.raises(ValueError) as jax_err:
        JD.stream_file_histogram(MmapReader(path), mesh=mesh1, batch_records=1000)
    with pytest.raises(ValueError) as port_err:
        TD.stream_file_histogram(MmapReader(path), device=CPU, batch_records=1000)
    assert str(port_err.value) == str(jax_err.value)


def test_stream_hint_is_computed_on_the_host(tmp_path):
    from ibu_tpu_torch.io.stream import stream_file

    small = pooled_records(300, 10, 10, bits=32, extremes=False)
    full = pooled_records(300, 11, 10)
    path = write(tmp_path, "h.ibu", np.concatenate([small, full]))
    got = list(stream_file(path, device=CPU, batch_records=300, with_hint=True))
    assert [hint for _, hint in got] == [True, False]
    assert all(isinstance(t, torch.Tensor) for t in stream_file(path, device=CPU, batch_records=300))


@pytest.mark.parametrize("sorted_file", [False, True])
@pytest.mark.parametrize("engine", ["host", "device"])
def test_barcode_counts_matches_jax(tmp_path, stream_records, engine, sorted_file):
    records, _ = stream_records
    if sorted_file:
        records = sort_records(records)
    path = write(tmp_path, "c.ibu", records, sorted_flag=sorted_file)
    want = JPL.barcode_counts(path, engine="host", batch_records=1000)
    got = TPL.barcode_counts(path, engine=engine, batch_records=1000, device=CPU)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_barcode_counts_errors_match_jax(tmp_path, stream_records):
    records, _ = stream_records
    gz = write(tmp_path, "c.ibu.gz", records, compression="gzip")
    with pytest.raises(ValueError) as jax_err:
        JPL.barcode_counts(gz)
    with pytest.raises(ValueError) as port_err:
        TPL.barcode_counts(gz, device=CPU)
    assert str(port_err.value) == port_text(str(jax_err.value))
    plain = write(tmp_path, "c.ibu", records)
    with pytest.raises(ValueError) as jax_err:
        JPL.barcode_counts(plain, engine="auto")
    with pytest.raises(ValueError) as port_err:
        TPL.barcode_counts(plain, engine="auto")
    assert str(port_err.value) == str(jax_err.value)
    empty = write(tmp_path, "e.ibu", records[:0])
    for engine in ("host", "device"):
        keys, counts = TPL.barcode_counts(empty, engine=engine, device=CPU)
        assert keys.dtype == np.uint64 and counts.dtype == np.int64 and len(keys) == 0


def test_gzip_stream_into_device_engines(tmp_path, stream_records):
    """Compressed input reaches the device engines as host batches, as the
    JAX package's histogram command feeds them."""
    records, _ = stream_records
    gz = write(tmp_path, "g.ibu.gz", records, compression="gzip")
    want = JPL.host_stream_histogram(Reader.from_path(gz).batches())
    assert TPL.host_stream_histogram(Reader.from_path(gz).batches()) == want
    hist = TD.DeviceHistogram(capacity=1024, max_uniques_per_shard=1024, device=CPU)
    assert hist.run(Reader.from_path(gz).batches()) == want
    got = TD.sharded_barcode_histogram(Reader.from_path(gz).batches(), device=CPU)
    assert got == want == TS.barcode_histogram_np(records)
    assert TPL.host_stream_histogram(iter([])) == JPL.host_stream_histogram(iter([])) == {}


# ---------------------------------------------------------------------------
# a running histogram carried across from the JAX package
# ---------------------------------------------------------------------------


def test_histogram_state_carried_across_from_jax(mesh1, stream_records):
    """Four batches in the JAX engine (merged every 2, so its stage is
    empty), the table converted, three more in the port: the JAX package's
    final dict."""
    records, batches = stream_records
    kw = dict(capacity=1024, max_uniques_per_shard=1024)
    jax_hist = JD.DeviceHistogram(mesh=mesh1, merge_every=2, **kw)
    for b in batches[:4]:
        jax_hist.update(b)
    state = histogram_state_from_jax(jax_hist._state)
    port = TD.DeviceHistogram(device=CPU, **kw)
    port.resume(state)
    for b in batches[4:]:
        port.update(b)
    want = JD.DeviceHistogram(mesh=mesh1, **kw).run(iter(batches))
    assert port.finalize() == want == TS.barcode_histogram_np(records)
    jax_hist.update(batches[4])  # staged, not merged
    with pytest.raises(ValueError, match="staged"):
        histogram_state_from_jax(jax_hist._state)
    with pytest.raises(ValueError, match="capacity"):
        TD.DeviceHistogram(capacity=512, max_uniques_per_shard=1024, device=CPU).resume(state)
