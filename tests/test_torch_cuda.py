"""The CUDA codec kernels against their plain torch versions, on the card.

Every test here is marked ``cuda`` and skips where no CUDA card is present.
The file imports no jax, so on a machine with a card it runs alone:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Outputs are bytes and integers; kernel and plain version must agree exactly.
"""

import numpy as np
import pytest
import torch

from ibu_tpu import Header, MmapReader, Writer
from ibu_tpu.constructs.record import make_records
from ibu_tpu_torch import pipelines as TPL
from ibu_tpu_torch.ops import codec as TC
from ibu_tpu_torch.ops import codec_cuda as K

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
