"""The CUDA codec kernels, the codec labs' and the sort lab's kernels against
their plain torch versions, and the histogram engines and validation matrix,
on the card.

Every test here is marked ``cuda`` and skips where no CUDA card is present.
The file imports no jax, so on a machine with a card it runs alone:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Outputs are bytes and integers; kernel and plain version must agree exactly.
"""

import numpy as np
import pytest
import torch

from ibu_tpu_torch import Header, MmapReader, Writer, make_records
from ibu_tpu_torch import pipelines as TPL
from ibu_tpu_torch.labs import _kernels as LK
from ibu_tpu_torch.labs import _sort_kernels as SK
from ibu_tpu_torch.labs import kernel_lab, sol_lab, sort_lab
from ibu_tpu_torch.ops import _build
from ibu_tpu_torch.ops import codec as TC
from ibu_tpu_torch.ops import codec_cuda as K
from ibu_tpu_torch.ops import stats as TS
from ibu_tpu_torch.parallel import device as TD

pytestmark = pytest.mark.cuda

LENGTHS = [1, 15, 16, 17, 31, 32]
FIELD_LENGTHS = [(L, 12) for L in LENGTHS] + [(16, L) for L in LENGTHS]
N = 100_003  # not a multiple of the 256-thread block


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def rows(n, L, seed, alphabet=b"ACGT"):
    rng = np.random.default_rng(seed)
    return np.frombuffer(alphabet, np.uint8)[rng.integers(0, len(alphabet), (n, L))]


def full_range_index(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 64, size=n, dtype=np.uint64).view(np.int64)


def on(card, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(card) for a in arrays]


def assert_encode_matches(bc, umi, idx):
    got = K.encode_records(bc, umi, idx)
    want = K.plain_encode_records(bc, umi, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    return got


@pytest.mark.parametrize("bc_len,umi_len", FIELD_LENGTHS)
def test_encode_kernel_matches_plain(card, bc_len, umi_len):
    bc, umi, idx = on(
        card, rows(N, bc_len, 1), rows(N, umi_len, 2), full_range_index(N, 3)
    )
    assert_encode_matches(bc, umi, idx)


@pytest.mark.parametrize("bc_len,umi_len", FIELD_LENGTHS)
def test_decode_kernel_matches_plain(card, bc_len, umi_len):
    rng = np.random.default_rng(bc_len * 33 + umi_len)
    (records,) = on(card, rng.integers(0, 1 << 64, (N, 3), dtype=np.uint64).view(np.int64))
    got = K.decode_records(records, bc_len, umi_len)
    want = K.plain_decode_records(records, bc_len, umi_len)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_lowercase_all_t32_and_bit63(card):
    bc, umi, idx = on(card, rows(N, 20, 4, b"acgt"), rows(N, 10, 5, b"ACGTacgt"),
                      full_range_index(N, 6))
    records = assert_encode_matches(bc, umi, idx)
    upper, _, back = K.decode_records(records, 20, 10)
    torch.cuda.synchronize()
    assert torch.equal(upper.cpu(), torch.from_numpy(rows(N, 20, 4, b"ACGT")))
    assert torch.equal(back, idx)
    t32 = torch.full((N, 32), ord("T"), dtype=torch.uint8, device=card)
    ones = torch.full((N,), -1, dtype=torch.int64, device=card)
    records = assert_encode_matches(t32, t32, ones)
    assert bool((records == -1).all())


def test_unaligned_rows_take_the_byte_path(card):
    """A contiguous row view whose base is not 4-byte aligned."""
    n, L = 4099, 16
    buf = torch.from_numpy(rows(1, n * L + 1, 7)[0]).to(card)
    bc = buf[1:].view(n, L)
    umi = buf[1 : 1 + n * 12].view(n, 12)
    idx = torch.arange(n, dtype=torch.int64, device=card)
    records = assert_encode_matches(bc, umi, idx)
    assert torch.equal(K.decode_records(records, L, 12)[0], bc)


SALTS = [0, 1, 0xA5A5A5A5, 0xFFFFFFFF]


@pytest.mark.parametrize("salt", SALTS)
def test_salted_kernels_match_plain(card, salt):
    bc, umi, idx = on(card, rows(N, 16, 13), rows(N, 12, 14), full_range_index(N, 15))
    got = K.encode_records(bc, umi, idx, salt)
    want = K.plain_encode_records(bc, umi, idx, salt)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    out = K.decode_records(got, 16, 12, salt)
    plain = K.plain_decode_records(got, 16, 12, salt)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, plain))
    assert torch.equal(out[2], idx)


@pytest.mark.parametrize("length", LENGTHS)
def test_plane_kernels_match_plain(card, length):
    (field,) = on(card, rows(N, length, length))
    words = K.encode_planes(field)
    assert torch.equal(words, K.plain_encode_planes(field))
    rng = np.random.default_rng(length)
    (noise,) = on(card, rng.integers(0, 1 << 64, N, dtype=np.uint64).view(np.int64))
    for w in (words, noise):  # bits above 2L are ignored
        assert torch.equal(K.decode_planes(w, length), K.plain_decode_planes(w, length))
    torch.cuda.synchronize()
    assert torch.equal(K.decode_planes(words, length), field)


def test_plane_kernels_edges(card):
    lower, mixed = on(card, rows(N, 20, 16, b"acgt"), rows(N, 7, 17, b"ACGTacgt"))
    for field in (lower, mixed):
        assert torch.equal(K.encode_planes(field), K.plain_encode_planes(field))
    assert torch.equal(K.decode_planes(K.encode_planes(lower), 20).cpu(),
                       torch.from_numpy(rows(N, 20, 16, b"ACGT")))
    t32 = torch.full((N, 32), ord("T"), dtype=torch.uint8, device=card)
    assert bool((K.encode_planes(t32) == -1).all())
    n, L = 4099, 16
    buf = torch.from_numpy(rows(1, n * L + 1, 18)[0]).to(card)
    view = buf[1:].view(n, L)  # base not 4-byte aligned: the byte path
    assert torch.equal(K.encode_planes(view), K.plain_encode_planes(view))
    assert torch.equal(K.decode_planes(K.encode_planes(view), L), view)
    empty = torch.empty((0, 16), dtype=torch.uint8, device=card)
    assert K.encode_planes(empty).shape == (0,)
    assert K.decode_planes(torch.empty(0, dtype=torch.int64, device=card), 16).shape == (0, 16)
    torch.cuda.synchronize()


def test_histogram_engines_on_card(card, tmp_path):
    rng = np.random.default_rng(19)
    n = 50_000
    pool = rng.integers(0, 1 << 64, 3000, dtype=np.uint64)
    pool[:2] = (0, (1 << 64) - 1)  # barcode 0 and the u64 maximum
    records = make_records(pool[rng.integers(0, 3000, n)],
                           rng.integers(0, 1 << 24, n, dtype=np.uint64),
                           np.arange(n, dtype=np.uint64))
    want = TS.barcode_histogram_np(records)
    for spill, capacity in ((True, 512), (False, 4096)):
        h = TD.DeviceHistogram(capacity=capacity, max_uniques_per_shard=4096,
                               merge_every=3, spill=spill, device=card)
        assert h.run(iter(np.array_split(records, 7))) == want
    srt = np.sort(records, order=("barcode", "umi", "index"))
    h = TD.DeviceHistogram(capacity=4096, max_uniques_per_shard=4096, assume_sorted=True,
                           device=card)
    assert h.run(iter(np.array_split(srt, 5))) == want
    lie = TD.DeviceHistogram(capacity=4096, max_uniques_per_shard=4096, assume_sorted=True,
                             device=card)
    lie.update(records)
    with pytest.raises(ValueError, match="sorted"):
        lie.finalize()
    path = str(tmp_path / "h.ibu")
    with Writer.from_path(path, Header.new(32, 12)) as w:
        w.write_batch(records)
    got = TD.stream_file_histogram(MmapReader(path), device=card, batch_records=6000,
                                   max_uniques_per_shard=4096)
    assert got == want
    keys, counts = TPL.barcode_counts(path, engine="device", device=card, batch_records=6000,
                                      max_uniques_per_shard=4096)
    assert dict(zip(keys.tolist(), counts.tolist())) == want
    dev = torch.from_numpy(records.view(np.int64).reshape(-1, 3).copy()).to(card)
    assert TS.table_dict(*TS.molecule_counts(dev, 4096)[:2]) == TS.molecule_counts_np(records)
    assert (TS.table_dict(*TS.pair_molecule_counts(dev, 1 << 16)[:2])
            == TS.pair_molecule_counts_np(records))


@pytest.mark.parametrize("assume_sorted", [False, True])
@pytest.mark.parametrize("spill", [True, False])
def test_histogram_update_never_waits_on_the_card(card, spill, assume_sorted):
    """No step of ``update_placed``, merges included, synchronises with the
    card (CUDA's sync debug mode raises on any that does)."""
    records = np.sort(make_records(
        np.random.default_rng(20).integers(0, 5000, 60_000, dtype=np.uint64),
        np.zeros(60_000, np.uint64), np.arange(60_000, dtype=np.uint64)), order="barcode")
    batches = [torch.from_numpy(b.view(np.int64).reshape(-1, 3).copy()).to(card)
               for b in np.array_split(records, 7)]
    h = TD.DeviceHistogram(capacity=8192, max_uniques_per_shard=8192, merge_every=2,
                           spill=spill, assume_sorted=assume_sorted, device=card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for b in batches:
            h.update_placed(b, bc16=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert h.finalize() == TS.barcode_histogram_np(records)


def test_validation_matrix_on_card(card):
    from ibu_tpu_torch.validate import run_matrix

    results = run_matrix(device=card)
    assert len(results) == 27 and all(ok for _, ok in results), results


def test_launch_counters_and_empty_batch(card, monkeypatch):
    monkeypatch.setattr(K.encode_records, "launches", 0)
    monkeypatch.setattr(K.decode_records, "launches", 0)
    empty = torch.empty((0, 16), dtype=torch.uint8, device=card)
    idx = torch.empty((0,), dtype=torch.int64, device=card)
    assert K.encode_records(empty, empty[:, :12].contiguous(), idx).shape == (0, 3)
    assert K.encode_records.launches == 0
    bc, umi, idx = on(card, rows(1000, 16, 8), rows(1000, 12, 9), full_range_index(1000, 10))
    K.decode_records(K.encode_records(bc, umi, idx), 16, 12)
    torch.cuda.synchronize()
    assert (K.encode_records.launches, K.decode_records.launches) == (1, 1)


def test_pipelines_on_card(card, tmp_path):
    n = 20_011
    bc, umi = rows(n, 16, 11), rows(n, 12, 12)
    path = str(tmp_path / "s.ibu")
    TPL.encode_sorted_file(path, bc, umi, device=card)
    oracle = np.sort(
        make_records(TC.np_pack(bc), TC.np_pack(umi), np.arange(n, dtype=np.uint64)),
        order=("barcode", "umi", "index"),
    )
    assert np.asarray(MmapReader(path).records).tobytes() == oracle.tobytes()
    _, got_bc, got_umi, got_idx = TPL.decode_file(path, device=card)
    assert np.array_equal(got_bc, TC.np_unpack(oracle["barcode"], 16))
    assert np.array_equal(got_idx, oracle["index"])
    # the stream ring: many small batches and a ragged tail
    stats_path = str(tmp_path / "t.ibu")
    with Writer.from_path(stats_path, Header.new(16, 12)) as w:
        w.write_batch(oracle)
    from ibu_tpu_torch.parallel.device import stream_file_stats

    got = stream_file_stats(MmapReader(stats_path), device=card, batch_records=1000)
    assert got["count"] == n
    assert got["barcode_sum"] == int(oracle["barcode"].sum(dtype=object)) % (1 << 64)
    assert got["index_sum"] == n * (n - 1) // 2


# ---------------------------------------------------------------------------
# the single-cell workflow after ingest (torch ops on the card)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("length", [1, 12, 16, 17, 32])
def test_torch_correct_unique_on_card(card, length):
    from ibu_tpu_torch.ops import correct as TCorr

    rng = np.random.default_rng(length)
    hi = 1 << 64 if length == 32 else 1 << (2 * length)
    allow = np.unique(rng.integers(0, hi, 1 if length == 1 else 3000, dtype=np.uint64))
    deltas = TCorr.variant_deltas(length)
    near = allow[rng.integers(0, len(allow), 5000)] ^ deltas[rng.integers(0, len(deltas), 5000)]
    uniq = np.unique(np.concatenate([allow[:100], near, rng.integers(0, hi, 5000, dtype=np.uint64)]))
    want = TCorr.np_correct_unique(uniq, allow, length)
    fixed, status = TCorr.torch_correct_unique(*on(card, uniq.view(np.int64), allow.view(np.int64)),
                                               length)
    assert np.array_equal(fixed.cpu().numpy().view(np.uint64), want[0])
    assert np.array_equal(status.cpu().numpy(), want[1])
    barcodes = uniq[rng.integers(0, len(uniq), 20_000)]
    got = TCorr.correct_batch(barcodes, allow, length, device=card)
    want = TCorr.correct_batch(barcodes, allow, length, device="cpu")
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    if length == 32:
        assert (uniq >> np.uint64(63)).any()


def write_records(path, recs, bc_len=16, umi_len=12, sorted_flag=False):
    header = Header.new(bc_len, umi_len)
    if sorted_flag:
        header.set_sorted()
    with Writer.from_path(str(path), header) as w:
        w.write_batch(recs)
    return str(path)


@pytest.mark.parametrize("bc_len,bits", [(16, 32), (32, 64)])
def test_sort_file_device_on_card(card, tmp_path, bc_len, bits):
    rng = np.random.default_rng(bits)
    n = 200_003
    recs = make_records(rng.integers(0, 1 << bits, n, dtype=np.uint64) % np.uint64(5000),
                        rng.integers(0, 1 << bits, n, dtype=np.uint64),
                        rng.integers(0, 1 << 64, n, dtype=np.uint64))
    if bits == 64:
        recs["barcode"] |= np.uint64(1 << 63)
    src = write_records(tmp_path / "u.ibu", recs, bc_len, bc_len)
    TPL.sort_file_device(src, str(tmp_path / "s.ibu"), device=card)
    want = recs[np.lexsort((recs["index"], recs["umi"], recs["barcode"]))]
    got = MmapReader(str(tmp_path / "s.ibu"))
    assert got.header().sorted() and np.asarray(got.records).tobytes() == want.tobytes()


@pytest.mark.parametrize("batch", [1 << 14, 1 << 20])
def test_count_matrix_device_on_card(card, tmp_path, batch):
    rng = np.random.default_rng(batch)
    n = 300_000
    recs = make_records(rng.integers(0, 300, n, dtype=np.uint64),
                        rng.integers(0, 64, n, dtype=np.uint64),
                        rng.integers(0, 2000, n, dtype=np.uint64))
    recs = recs[np.lexsort((recs["index"], recs["umi"], recs["barcode"]))]
    src = write_records(tmp_path / "m.ibu", recs, sorted_flag=True)
    dev = TPL.count_matrix(src, str(tmp_path / "d"), batch_records=batch, engine="device",
                           max_pairs=1 << 22, device=card)
    host = TPL.count_matrix(src, str(tmp_path / "h"), batch_records=batch)
    assert dev == host and dev["entries"] > 1 << 14
    for ext in (".mtx", ".barcodes.txt", ".indices.txt"):
        assert (tmp_path / f"d{ext}").read_bytes() == (tmp_path / f"h{ext}").read_bytes()


# ---------------------------------------------------------------------------
# the codec labs' kernels (ibu_tpu_torch/labs, csrc/codec_lab.cu)
# ---------------------------------------------------------------------------

BLOCKS = [128, 256, 512]
ANY_BYTE = bytes(range(256))  # the codec is total and the floors see raw bytes


def lab_rows(card, seed):
    return on(card, rows(N, 16, seed, ANY_BYTE), rows(N, 12, seed + 1, ANY_BYTE),
              full_range_index(N, seed + 2))


def random_records(card, seed, cols=3):
    rng = np.random.default_rng(seed)
    return on(card, rng.integers(0, 1 << 64, (N, cols), dtype=np.uint64).view(np.int64))[0]


def assert_all_equal(got, want):
    torch.cuda.synchronize()
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("mode", LK.ENC_MODES)
def test_lab_sol_encode_matches_plain(card, mode, block):
    bc, umi, idx = lab_rows(card, 40)
    assert_all_equal(LK.sol_encode(bc, umi, idx, mode, block),
                     LK.plain_sol_encode(bc, umi, idx, mode))


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("mode", LK.DEC_MODES)
def test_lab_sol_decode_matches_plain(card, mode, block):
    records = random_records(card, 41)
    assert_all_equal(LK.sol_decode(records, mode, block), LK.plain_sol_decode(records, mode))


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("sol", [False, True])
def test_lab_packed_matches_plain(card, sol, block):
    bc, umi, idx = lab_rows(card, 42)
    bcp, umip = bc.view(torch.int32), umi.view(torch.int32)
    assert_all_equal(LK.packed_encode(bcp, umip, idx, sol, block),
                     LK.plain_packed_encode(bcp, umip, idx, sol))
    records = random_records(card, 43)
    assert_all_equal(LK.packed_decode(records, sol, block), LK.plain_packed_decode(records, sol))


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("cols", [3, 4])
@pytest.mark.parametrize("enc_in", ["sep", "comb"])
def test_lab_layout_encode_matches_plain(card, enc_in, cols, block):
    bc, umi, idx = lab_rows(card, 44)
    ascii_rows = (bc, umi) if enc_in == "sep" else on(card, rows(N, 32, 47, ANY_BYTE))
    assert_all_equal(LK.layout_encode(ascii_rows, idx, cols, block),
                     LK.plain_layout_encode(ascii_rows, idx, cols))


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("cols", [3, 4])
@pytest.mark.parametrize("comb", [False, True])
def test_lab_layout_decode_matches_plain(card, comb, cols, block):
    records = random_records(card, 45 + cols, cols)  # a (N, 4) word 3 is ignored
    assert_all_equal(LK.layout_decode(records, comb, block), LK.plain_layout_decode(records, comb))


def test_lab_misaligned_row_views(card):
    """Row views whose base is 1 or 4 bytes past a 16-byte boundary take the
    byte and word paths."""
    n = 4099
    buf = torch.from_numpy(rows(1, 32 * n + 16, 48, ANY_BYTE)[0]).to(card)
    idx = torch.arange(n, dtype=torch.int64, device=card)
    for off in (1, 4):
        bc = buf[off:off + 16 * n].view(n, 16)
        umi = buf[off:off + 12 * n].view(n, 12)
        for mode in LK.ENC_MODES:
            assert_all_equal(LK.sol_encode(bc, umi, idx, mode), LK.plain_sol_encode(bc, umi, idx, mode))
        comb = (buf[off:off + 32 * n].view(n, 32),)
        for cols in (3, 4):
            assert_all_equal(LK.layout_encode(comb, idx, cols), LK.plain_layout_encode(comb, idx, cols))
            assert_all_equal(LK.layout_encode((bc, umi), idx, cols),
                             LK.plain_layout_encode((bc, umi), idx, cols))


def test_lab_launch_counters_and_empty(card, monkeypatch):
    for name, (kernel, _, _) in LK.KERNELS.items():
        monkeypatch.setattr(kernel, "launches", 0)
    empty = torch.empty((0,), dtype=torch.int64, device=card)
    assert LK.sol_encode(torch.empty((0, 16), dtype=torch.uint8, device=card),
                         torch.empty((0, 12), dtype=torch.uint8, device=card), empty).shape == (0, 3)
    assert LK.sol_encode.launches == 0
    bc, umi, idx = lab_rows(card, 49)
    records = LK.sol_encode(bc, umi, idx)
    LK.sol_decode(records)
    LK.packed_decode(LK.packed_encode(bc.view(torch.int32), umi.view(torch.int32), idx))
    LK.layout_decode(LK.layout_encode((bc, umi), idx))
    torch.cuda.synchronize()
    assert {name: k.launches for name, (k, _, _) in LK.KERNELS.items()} == dict.fromkeys(LK.KERNELS, 1)


def test_labs_run_on_card(card, capsys):
    assert sol_lab.main(["--records", str(N), "--runs", "2"]) == 0
    assert kernel_lab.main(["--records", str(N), "--runs", "2"]) == 0
    out = capsys.readouterr().out
    assert out.count("copy floor (sol_touch)") == 2 and "FAILED" not in out


# ---------------------------------------------------------------------------
# the sort lab's kernels (ibu_tpu_torch/labs/_sort_kernels.py, csrc/sort_lab.cu)
# ---------------------------------------------------------------------------

SORT_N = 1 << 20


def sort_cases(card):
    """``(label, keys)``: the lab's keys, keys that all share one low byte,
    every digit 8 times in every tile, and the smallest legal count."""
    keys = sort_lab.make_keys(SORT_N, 3, card)
    every = (torch.arange(SORT_N, device=card).flip(0) % 256).to(torch.int32)
    return [("lab keys", keys), ("one low byte", (keys & -256) | 0x5A),
            ("every digit", every),
            ("16384 keys", sort_lab.make_keys(SK.KEYS_MULTIPLE, 4, card))]


def sort_offsets(card, keys, fill=None):
    offs = sort_lab.make_offsets(keys.shape[0] // SK.TILE)
    if fill is not None:
        offs = np.where(np.arange(offs.size).reshape(offs.shape) % 2 == 0, 0, 8).astype(np.int32)
    return torch.from_numpy(offs).to(card)


@pytest.mark.parametrize("name", list(SK.KERNELS))
def test_sort_lab_kernel_matches_plain(card, name):
    kernel, plain, _ = SK.KERNELS[name]
    for label, keys in sort_cases(card):
        for offs in (sort_offsets(card, keys), sort_offsets(card, keys, "0/8")):
            args = (keys, offs) if name == "dynamic_store" else (keys,)
            got, want = kernel(*args), plain(*args)
            torch.cuda.synchronize()
            assert got.shape == want.shape and got.dtype == want.dtype, label
            assert torch.equal(got, want), label


def test_sort_lab_kernels_match_numpy_oracles(card):
    keys = sort_lab.make_keys(SORT_N, 0, card)
    assert sort_lab.check(keys, sort_offsets(card, keys), log=lambda line: None) == []


def test_sort_lab_offsets_outside_the_block_are_skipped(card):
    keys = sort_lab.make_keys(SK.KEYS_MULTIPLE, 5, card)
    offs = sort_offsets(card, keys)
    offs[::5] = -1
    offs[1::7] = 9
    assert torch.equal(SK.dynamic_store(keys, offs), SK.plain_dynamic_store(keys, offs))


def test_sort_lab_launch_counters_and_checks(card, monkeypatch):
    for kernel, _, _ in SK.KERNELS.values():
        monkeypatch.setattr(kernel, "launches", 0)
    empty = torch.empty(0, dtype=torch.int32, device=card)
    assert SK.digit_histogram(empty).shape == (0, 256)
    assert SK.digit_histogram.launches == 0
    keys = sort_lab.make_keys(SK.KEYS_MULTIPLE, 6, card)
    SK.digit_histogram(keys)
    SK.rank_cumsum(keys)
    SK.dynamic_store(keys, sort_offsets(card, keys))
    torch.cuda.synchronize()
    assert {name: k.launches for name, (k, _, _) in SK.KERNELS.items()} == dict.fromkeys(SK.KERNELS, 1)
    with pytest.raises(ValueError, match="multiple of 16384"):
        SK.rank_cumsum(keys[:-128])
    with pytest.raises(ValueError, match="offs must be"):
        SK.dynamic_store(keys, sort_offsets(card, keys)[:-1])


def test_sort_lab_launch_failure_raises(card, monkeypatch):
    """A launch the card refuses raises, and counts no launch."""
    lib = _build.load()
    monkeypatch.setattr(SK.rank_cumsum, "launches", 0)
    monkeypatch.setattr(lib, "ibu_lab_rank_cumsum", lambda *args: 1)  # cudaErrorInvalidValue
    with pytest.raises(RuntimeError, match="rank_cumsum kernel launch failed: CUDA error 1"):
        SK.rank_cumsum(sort_lab.make_keys(SK.KEYS_MULTIPLE, 7, card))
    assert SK.rank_cumsum.launches == 0


def test_sort_lab_runs_on_card(card, capsys):
    assert sort_lab.main(["--records", str(1 << 18), "--runs", "2"]) == 0
    out = capsys.readouterr().out
    assert "per-pass floor (max of K2/K3)" in out and "FAILED" not in out


SORT_SIZES = [8 * SK.TILE, 24 * SK.TILE, SORT_N]  # 8 and 24 tiles: several tiles per block


@pytest.mark.parametrize("n", SORT_SIZES)
@pytest.mark.parametrize("case", sort_lab.RANK_CASES)
def test_sort_lab_rank_cases_match_plain(card, case, n):
    keys = sort_lab.case_keys(n, case, card)
    got, want = SK.rank_cumsum(keys), SK.plain_rank_cumsum(keys)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if case == "one digit":
        assert int(got.max()) == SK.TILE - 1


@pytest.mark.parametrize("n", SORT_SIZES)
@pytest.mark.parametrize("case", sort_lab.STORE_CASES)
def test_sort_lab_store_cases_match_plain(card, case, n):
    keys = sort_lab.make_keys(n, 8, card)
    offs = torch.from_numpy(sort_lab.case_offsets(n // SK.TILE, case)).to(card)
    got, want = SK.dynamic_store(keys, offs), SK.plain_dynamic_store(keys, offs)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_sort_lab_wrappers_refuse_unaligned_tensors(card):
    keys = sort_lab.make_keys(SK.KEYS_MULTIPLE + 1, 9, card)[1:]  # 4 bytes past a boundary
    offs = sort_offsets(card, keys)
    for call in (lambda: SK.digit_histogram(keys), lambda: SK.rank_cumsum(keys),
                 lambda: SK.dynamic_store(keys, offs)):
        with pytest.raises(ValueError, match="16-byte boundary"):
            call()


# ---------------------------------------------------------------------------
# FASTQ export and ingest, and engine auto-selection, on the card
# ---------------------------------------------------------------------------

FASTQ_READS = 300_000
EXPORT_BATCH = 70_001  # neither batch divides the read count
INGEST_BATCH = 64_007


@pytest.fixture
def fresh_select(monkeypatch):
    from ibu_tpu_torch.parallel import select

    monkeypatch.delenv("IBU_AUTO_ENGINE", raising=False)
    select.reset_probe_memo()
    yield select
    select.reset_probe_memo()


def test_fastq_export_and_ingest_on_card_equal_the_cpu(card, tmp_path, fresh_select, monkeypatch):
    monkeypatch.setenv("IBU_AUTO_ENGINE", "device")
    n = FASTQ_READS
    src = str(tmp_path / "src.ibu")
    TPL.encode_sorted_file(src, rows(n, 16, 41), rows(n, 12, 42), device=card)
    files = {}
    launches = {}
    for tag, device in (("card", card), ("cpu", "cpu")):
        fq, back = str(tmp_path / f"{tag}.fastq"), str(tmp_path / f"{tag}.ibu")
        K.decode_records.launches = K.encode_records.launches = 0
        assert TPL.export_fastq(src, fq, batch_records=EXPORT_BATCH, device=device) == n
        assert TPL.ingest_fastq(fq, back, 16, 12, batch=INGEST_BATCH, device=device) == n
        launches[tag] = (K.decode_records.launches, K.encode_records.launches)
        files[tag] = (fq, back)
    # one launch per batch on the card, none on the CPU
    assert launches["card"] == (-(-n // EXPORT_BATCH), -(-n // INGEST_BATCH))
    assert launches["cpu"] == (0, 0)
    for a, b in zip(files["card"], files["cpu"]):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    # export writes reads in sorted order, so the file comes back with
    # arange as its index column
    want = np.asarray(MmapReader(src).records).copy()
    want["index"] = np.arange(n, dtype=np.uint64)
    assert np.array_equal(np.asarray(MmapReader(files["card"][1]).records), want)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "card.fastq", "card.ibu", "cpu.fastq", "cpu.ibu", "src.ibu"]


def test_fastq_host_engine_on_card_machine_launches_nothing(card, tmp_path, fresh_select,
                                                            monkeypatch):
    n = 50_000
    src = str(tmp_path / "src.ibu")
    TPL.encode_sorted_file(src, rows(n, 16, 43), rows(n, 12, 44), device=card)
    outs = {}
    for engine in ("device", "host"):
        monkeypatch.setenv("IBU_AUTO_ENGINE", engine)
        K.decode_records.launches = K.encode_records.launches = 0
        fq, back = str(tmp_path / f"{engine}.fastq.gz"), str(tmp_path / f"{engine}.ibu.gz")
        TPL.export_fastq(src, fq, device=card)
        TPL.ingest_fastq(fq, back, 16, 12, device=card)
        assert (K.decode_records.launches > 0) == (engine == "device")
        assert (K.encode_records.launches > 0) == (engine == "device")
        from ibu_tpu_torch import Reader

        outs[engine] = np.concatenate(list(Reader.from_path(back).batches()))
    assert np.array_equal(outs["device"], outs["host"]) and len(outs["host"]) == n


def test_auto_on_card_picks_an_engine_and_says_so(card, tmp_path, fresh_select, capsys):
    select = fresh_select
    codec = select.auto_codec_engine(device=card)
    err = capsys.readouterr().err
    assert codec in ("device", "host")
    assert err.startswith("codec engine auto: device link ~") and f"-> {codec} " in err
    assert select._MEMO["device_gbps"] > 0 and select._MEMO["codec_engine"] == codec
    assert select.auto_codec_engine(device=card) == codec and capsys.readouterr().err == ""

    binary = select.auto_device_or_host(device=card, what="histogram")
    err = capsys.readouterr().err
    assert binary in ("device", "host") and err.startswith("engine auto (histogram): device feed ~")

    n = 200_000
    path = str(tmp_path / "s.ibu")
    i = np.arange(n, dtype=np.uint64)
    with Writer.from_path(path, Header.new(16, 12)) as w:
        w.write_batch(make_records(i, i * np.uint64(3), i))
    stats = TPL.file_stats(path, device=card)
    err = capsys.readouterr().err
    assert stats["engine"] in ("device", "native", "host") and f"-> {stats['engine']} " in err
    assert stats["count"] == n and stats["index_sum"] == n * (n - 1) // 2
    # the default engines give the bytes of the forced ones
    bc, umi = rows(1000, 16, 45), rows(1000, 12, 46)
    auto = TPL.encode_batch(bc, umi, i[:1000], device=card)
    assert auto.tobytes() == TPL.encode_batch(bc, umi, i[:1000], engine="device",
                                              device=card).tobytes()
    for a, b in zip(TPL.decode_batch(auto, 16, 12, device=card), (bc, umi, i[:1000])):
        assert np.array_equal(a, b)


def test_feed_probe_on_card_times_pinned_copies(card, fresh_select):
    gbps = fresh_select.measure_device_feed_gbps(device=card)
    assert 0.05 < gbps < 200


def test_cli_codec_commands_on_card_equal_the_cpu(card, tmp_path, fresh_select, monkeypatch,
                                                  capsys):
    """``decode``, ``export-fastq`` and ``ingest-fastq`` through
    ``ibu_tpu_torch.__main__.main`` with no ``--device`` (the card) and with
    ``--device cpu``: the same output, and the codec kernels launched once
    per batch on the card only."""
    from ibu_tpu_torch import DEFAULT_BUFFER_RECORDS
    from ibu_tpu_torch.__main__ import main

    monkeypatch.setenv("IBU_AUTO_ENGINE", "device")
    n = 150_001
    src = str(tmp_path / "src.ibu")
    TPL.encode_sorted_file(src, rows(n, 16, 47), rows(n, 12, 48), device=card)
    reader_batches = -(-n // DEFAULT_BUFFER_RECORDS)  # one decode per Reader batch
    outs, launches = {}, {}
    for tag, extra in (("card", []), ("cpu", ["--device", "cpu"])):
        fq, back = str(tmp_path / f"{tag}.fastq"), str(tmp_path / f"{tag}.ibu")
        K.decode_records.launches = K.encode_records.launches = 0
        assert main(["decode", src, *extra]) == 0
        tsv = capsys.readouterr().out
        decoded = K.decode_records.launches
        assert main(["export-fastq", src, fq, *extra]) == 0
        exported = K.decode_records.launches - decoded
        assert main(["ingest-fastq", fq, back, *extra]) == 0
        capsys.readouterr()
        launches[tag] = (decoded, exported, K.encode_records.launches)
        with open(fq, "rb") as a, open(back, "rb") as b:
            outs[tag] = (tsv, a.read(), b.read())
    assert launches["card"] == (reader_batches, 1, 1) and launches["cpu"] == (0, 0, 0)
    assert outs["card"] == outs["cpu"]
    assert outs["card"][0].count("\n") == n


# ---------------------------------------------------------------------------
# the cohort layer on the card
# ---------------------------------------------------------------------------


def _by_key(recs):
    return np.sort(recs, order=("barcode", "umi", "index"))


def test_cohort_of_one_on_nccl(card, tmp_path):
    """A world of one on NCCL: the sample sort's gathers ride Gloo and its
    exchange NCCL; files equal ``native.sort_file``, dicts the host engines';
    the group is destroyed after."""
    import torch.distributed as dist

    from ibu_tpu_torch import native
    from ibu_tpu_torch.parallel import multihost as MH
    from ibu_tpu_torch.parallel import sort as MS

    rng = np.random.default_rng(61)
    n = 300_001
    pool = rng.integers(0, 1 << 32, 5000, dtype=np.uint64)  # under a batch's 65,536 barcodes
    recs = make_records(pool[rng.integers(0, 5000, n)],
                        rng.integers(0, 1 << 24, n, dtype=np.uint64),
                        np.arange(n, dtype=np.uint64))
    src = write_records(tmp_path / "u.ibu", recs, 16, 12)
    native.sort_file(src, str(tmp_path / "native.ibu"))
    want = (tmp_path / "native.ibu").read_bytes()
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}",
                            world_size=1, rank=0)
    try:
        assert MH.exchange_backend(card) == "nccl" and MH.exchange_backend("cpu") == "gloo"
        got = MS.sharded_sort_records(recs, device=card, bc_len=16, umi_len=12, index_bits=32)
        assert got.tobytes() == _by_key(recs).tobytes()
        MS.sort_file_mesh(src, str(tmp_path / "mesh.ibu"), device=card)
        for engine in ("mesh", "host"):
            MH.multihost_sort_file(src, str(tmp_path / f"{engine}.ibu"), device=card,
                                   engine=engine)
        for name in ("mesh", "host"):
            assert (tmp_path / f"{name}.ibu").read_bytes() == want
        stats = MH.multihost_file_stats(src, device=card)
        host = TPL.file_stats(src, engine="host")
        host.pop("engine", None)
        assert stats == host
        assert MH.multihost_barcode_histogram(src, device=card) == TS.barcode_histogram_np(recs)
    finally:
        dist.destroy_process_group()
    assert MH.process_count() == 1


def test_two_ranks_on_one_card_exchange_over_gloo(card, tmp_path):
    """Two ranks sharing the card: NCCL would refuse them, so the exchange
    takes Gloo through pinned host buffers, chosen from the gathered card
    identities on both ranks; the sort equals numpy's."""
    from tests.torch_cohort import launch

    recs = make_records(np.arange(50_000, dtype=np.uint64)[::-1].copy() % np.uint64(977),
                        np.zeros(50_000, np.uint64), np.arange(50_000, dtype=np.uint64))
    np.save(tmp_path / "r.npy", recs)
    ranks = launch(2, [("backend", "backend", {"device": "cuda"}),
                       ("sort", "sharded_sort", {"path": str(tmp_path / "r.npy"),
                                                 "device": "cuda", "bc_len": 16})], tmp_path / "c")
    assert [r["backend"] for r in ranks] == [
        ("ok", {"exchange": "gloo", "rank": k, "world": 2}) for k in range(2)]
    assert ranks[0]["sort"][0] == "ok"
    assert ranks[0]["sort"][1]["out"].tobytes() == _by_key(recs).tobytes()


@pytest.mark.parametrize("shuffle", [False, "global", "blocks"])
def test_record_loader_on_card(card, tmp_path, shuffle):
    from ibu_tpu_torch.data import RecordLoader

    rng = np.random.default_rng(62)
    n = 100_003
    recs = make_records(rng.integers(0, 1 << 32, n, dtype=np.uint64),
                        rng.integers(0, 1 << 24, n, dtype=np.uint64),
                        np.arange(n, dtype=np.uint64))
    src = write_records(tmp_path / "u.ibu", recs, 16, 12)
    kw = dict(shuffle=shuffle, seed=4, block_records=8192, drop_remainder=False)
    host = list(RecordLoader(src, 16384, to_device=False, **kw).host_batches(1))
    dev = list(RecordLoader(src, 16384, **kw).epoch(1))
    assert [t.device.type for t in dev] == ["cuda"] * len(host)
    for t, want in zip(dev, host):
        assert t.cpu().numpy().tobytes() == np.ascontiguousarray(want).tobytes()
