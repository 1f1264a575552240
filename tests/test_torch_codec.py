"""The torch record codec against the JAX package's, on the CPU.

The same seeded numpy inputs go through ``ibu_tpu``'s Pallas kernels (in
interpret mode, small tiles) and lax codec, and through ``ibu_tpu_torch``'s
plain versions and CUDA wrappers (which run the plain versions for CPU
tensors). Records cross through the ``(6, N)`` converters. Every comparison
is exact: the outputs are integers and bytes, so the tolerance is 0.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibu_tpu import MmapReader
from ibu_tpu.ops import codec as JC
from ibu_tpu.ops import codec_pallas as JP
from ibu_tpu_torch.ops import codec as TC
from ibu_tpu_torch.ops import codec_cuda as K
from ibu_tpu_torch.ops.u64 import jax_soa_from_records, records_from_jax_soa
from tests.test_codec import random_rows

FIXTURES = Path(__file__).parent / "fixtures"

LENGTHS = [1, 15, 16, 17, 31, 32]
#: (bc_len, umi_len): every listed length for the barcode, then for the UMI
FIELD_LENGTHS = [(L, 12) for L in LENGTHS] + [(16, L) for L in LENGTHS]
N = 333  # not a multiple of the 128-record test tile


def random_index(n, seed):
    """uint64 indices over the full range, bit 63 included."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 1 << 64, size=n, dtype=np.uint64)
    idx[0] = np.uint64(1 << 63)
    idx[1] = np.uint64((1 << 64) - 1)
    return idx


def torch_inputs(bc_rows, umi_rows, idx):
    return (
        torch.from_numpy(bc_rows.copy()),
        torch.from_numpy(umi_rows.copy()),
        torch.from_numpy(idx.view(np.int64).copy()),
    )


def jax_encode(bc_rows, umi_rows, idx, pallas: bool) -> np.ndarray:
    bc_p = jnp.asarray(JC.rows_to_planes(bc_rows))
    umi_p = jnp.asarray(JC.rows_to_planes(umi_rows))
    pair = jnp.asarray(JC.words_to_pair(idx))
    if pallas:
        soa = JP.encode_records(bc_p, umi_p, pair, tile_n=128, interpret=True)
    else:
        soa = jnp.concatenate(
            [JC.lax_encode_planes(bc_p), JC.lax_encode_planes(umi_p), pair]
        )
    return np.asarray(soa)


@pytest.mark.parametrize("bc_len,umi_len", FIELD_LENGTHS)
def test_encode_matches_pallas_and_lax(bc_len, umi_len):
    bc_rows = random_rows(N, bc_len, seed=bc_len)
    umi_rows = random_rows(N, umi_len, seed=100 + umi_len)
    idx = random_index(N, seed=bc_len * 33 + umi_len)
    got = K.plain_encode_records(*torch_inputs(bc_rows, umi_rows, idx))
    assert got.dtype == torch.int64 and got.shape == (N, 3)
    for pallas in (True, False):
        want = records_from_jax_soa(jax_encode(bc_rows, umi_rows, idx, pallas))
        assert torch.equal(got, want)
    # the CUDA wrapper takes the plain version for CPU tensors
    assert torch.equal(K.encode_records(*torch_inputs(bc_rows, umi_rows, idx)), got)


@pytest.mark.parametrize("bc_len,umi_len", FIELD_LENGTHS)
def test_decode_matches_pallas_and_lax(bc_len, umi_len):
    rng = np.random.default_rng(bc_len * 33 + umi_len)
    # arbitrary words: bits above 2L must be ignored by both decoders
    words = rng.integers(0, 1 << 64, size=(N, 3), dtype=np.uint64)
    records = torch.from_numpy(words.view(np.int64))
    soa = jnp.asarray(jax_soa_from_records(records))
    got = K.plain_decode_records(records, bc_len, umi_len)
    bc_p, umi_p, idx_pair = JP.decode_records(
        soa, bc_len, umi_len, tile_n=128, interpret=True
    )
    lax_bc = JC.lax_decode_planes(soa[0:2], bc_len)
    lax_umi = JC.lax_decode_planes(soa[2:4], umi_len)
    for want_bc, want_umi in ((bc_p, umi_p), (lax_bc, lax_umi)):
        assert np.array_equal(got[0].numpy(), JC.planes_to_rows(np.asarray(want_bc)))
        assert np.array_equal(got[1].numpy(), JC.planes_to_rows(np.asarray(want_umi)))
    assert np.array_equal(
        got[2].numpy().view(np.uint64), JC.pair_to_words(np.asarray(idx_pair))
    )
    wrapped = K.decode_records(records, bc_len, umi_len)
    assert all(torch.equal(a, b) for a, b in zip(wrapped, got))


@pytest.mark.parametrize("bc_len,umi_len", FIELD_LENGTHS)
def test_roundtrip_and_host_reference(bc_len, umi_len):
    bc_rows = random_rows(N, bc_len, seed=7 + bc_len)
    umi_rows = random_rows(N, umi_len, seed=8 + umi_len)
    idx = random_index(N, seed=9)
    records = K.plain_encode_records(*torch_inputs(bc_rows, umi_rows, idx))
    words = records.numpy().view(np.uint64)
    assert np.array_equal(words[:, 0], TC.np_pack(bc_rows))
    assert np.array_equal(words[:, 1], JC.np_pack(umi_rows))
    bc, umi, back = K.plain_decode_records(records, bc_len, umi_len)
    assert np.array_equal(bc.numpy(), bc_rows)
    assert np.array_equal(umi.numpy(), TC.np_unpack(words[:, 1], umi_len))
    assert np.array_equal(back.numpy().view(np.uint64), idx)


def test_lowercase_encodes_like_uppercase():
    lower = random_rows(N, 20, seed=3, lowercase=True)
    upper = np.frombuffer(bytes(lower).upper(), dtype=np.uint8).reshape(lower.shape)
    umi = random_rows(N, 10, seed=4, lowercase=True)
    idx = random_index(N, seed=5)
    got = K.plain_encode_records(*torch_inputs(lower, umi, idx))
    assert torch.equal(got, K.plain_encode_records(*torch_inputs(upper, umi, idx)))
    assert torch.equal(got, records_from_jax_soa(jax_encode(lower, umi, idx, True)))
    # decode gives uppercase
    bc, _, _ = K.plain_decode_records(got, 20, 10)
    assert np.array_equal(bc.numpy(), upper)


def test_all_t32_fixture_sets_bit63():
    """``allT32.ibu``: 32 T's in both fields pack to all-ones words."""
    reader = MmapReader(str(FIXTURES / "allT32.ibu"))
    header = reader.header()
    want = torch.from_numpy(np.asarray(reader.records).view(np.int64).reshape(-1, 3).copy())
    rows = np.full((1, 32), ord("T"), dtype=np.uint8)
    idx = np.asarray(reader.records)["index"].copy()
    got = K.encode_records(*torch_inputs(rows, rows, idx))
    assert torch.equal(got, want)
    assert int(got[0, 0]) == -1  # every bit set, bit 63 included
    bc, umi, back = K.decode_records(want, header.bc_len, header.umi_len)
    assert bytes(bc.numpy()[0]) == b"T" * 32 and bytes(umi.numpy()[0]) == b"T" * 32
    assert torch.equal(back, want[:, 2])


@pytest.mark.parametrize(
    "rows",
    [
        np.frombuffer(b"ACGTNACG", dtype=np.uint8).reshape(2, 4),
        np.frombuffer(b"acgtacg-", dtype=np.uint8).reshape(1, 8),
        np.frombuffer(b"AC\x00T", dtype=np.uint8).reshape(1, 4),
    ],
)
def test_validation_error_text_matches(rows):
    with pytest.raises(ValueError) as jax_err:
        JC.np_validate_ascii(rows)
    with pytest.raises(ValueError) as torch_err:
        TC.np_validate_ascii(rows)
    assert str(torch_err.value) == str(jax_err.value)


@pytest.mark.parametrize("bc_len,umi_len", [(33, 12), (16, 33), (16, 0)])
def test_length_error_text_matches(bc_len, umi_len):
    n = 4
    bc_rows = np.full((n, bc_len), ord("A"), dtype=np.uint8)
    umi_rows = np.full((n, umi_len), ord("A"), dtype=np.uint8)
    idx = np.arange(n, dtype=np.uint64)
    with pytest.raises(ValueError) as jax_err:
        JP.encode_records(
            jnp.asarray(JC.rows_to_planes(bc_rows)),
            jnp.asarray(JC.rows_to_planes(umi_rows)),
            jnp.asarray(JC.words_to_pair(idx)),
            tile_n=128,
            interpret=True,
        )
    with pytest.raises(ValueError) as torch_err:
        K.encode_records(*torch_inputs(bc_rows, umi_rows, idx))
    assert str(torch_err.value) == str(jax_err.value)
    records = torch.zeros((n, 3), dtype=torch.int64)
    with pytest.raises(ValueError) as jax_err:
        JP.decode_records(jnp.zeros((6, n), jnp.uint32), bc_len, umi_len, interpret=True)
    with pytest.raises(ValueError) as torch_err:
        K.decode_records(records, bc_len, umi_len)
    assert str(torch_err.value) == str(jax_err.value)


def test_wrapper_rejects_bad_tensors():
    rows = torch.full((4, 16), ord("A"), dtype=torch.uint8)
    idx = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="uint8"):
        K.encode_records(rows.to(torch.int32), rows, idx)
    with pytest.raises(ValueError, match="contiguous"):
        K.encode_records(rows.t(), rows, idx)
    with pytest.raises(ValueError, match="record counts differ"):
        K.encode_records(rows, rows[:3], idx)
    with pytest.raises(ValueError, match=r"\(N, 3\)"):
        K.decode_records(torch.zeros((4, 2), dtype=torch.int64), 16, 12)
    with pytest.raises(ValueError, match="int64"):
        K.decode_records(torch.zeros((4, 3), dtype=torch.int32), 16, 12)


def test_seq_helpers_match():
    seqs = ["ACGTACGTACGTACGT", "TTTTGGGGCCCCAAAA"]
    rows = TC.seqs_to_rows(seqs)
    assert np.array_equal(rows, JC.seqs_to_rows(seqs))
    assert TC.rows_to_seqs(rows) == JC.rows_to_seqs(rows)
    with pytest.raises(ValueError) as jax_err:
        JC.seqs_to_rows(["AC", "ACG"])
    with pytest.raises(ValueError) as torch_err:
        TC.seqs_to_rows(["AC", "ACG"])
    assert str(torch_err.value) == str(jax_err.value)


def test_seqs_api_doctests():
    import doctest

    results = doctest.testmod(TC, verbose=False)
    assert results.failed == 0 and results.attempted >= 4


@pytest.mark.parametrize("length", [1, 12, 16, 17, 32])
def test_encode_decode_seqs_match(length):
    rows = random_rows(300, length, seed=length, lowercase=length % 2 == 1)
    seqs = [bytes(r).decode() for r in rows]
    words = TC.encode_seqs(seqs)
    assert words.dtype == np.uint64 and np.array_equal(words, JC.encode_seqs(seqs))
    back = TC.decode_seqs(words, length)
    assert back == JC.decode_seqs(words, length) == [s.upper() for s in seqs]
    # plain lists and other integer dtypes are taken as words
    assert TC.decode_seqs(words.tolist(), length) == back


@pytest.mark.parametrize("seqs,validate", [
    (["A" * 33], True), (["ACGN"], True), (["AC", "ACG"], True)])
def test_encode_seqs_errors_match(seqs, validate):
    with pytest.raises(ValueError) as jax_err:
        JC.encode_seqs(seqs, validate=validate)
    with pytest.raises(ValueError) as torch_err:
        TC.encode_seqs(seqs, validate=validate)
    assert str(torch_err.value) == str(jax_err.value)
    if len(seqs[0]) == 33:
        assert str(torch_err.value) == "sequence length 33 exceeds 32 bases"


def test_encode_seqs_validates_by_default():
    assert np.array_equal(TC.encode_seqs(["ACGN"], validate=False),
                          JC.encode_seqs(["ACGN"], validate=False))


# ---------------------------------------------------------------------------
# single-field codec (encode_planes / decode_planes) and the salt
# ---------------------------------------------------------------------------


def jax_planes_words(rows) -> list[np.ndarray]:
    """``rows`` through the Pallas kernel (interpret mode) and the lax codec."""
    planes = jnp.asarray(JC.rows_to_planes(rows))
    pairs = (JP.encode_planes(planes, tile_n=256, interpret=True), JC.lax_encode_planes(planes))
    return [JC.pair_to_words(np.asarray(p)) for p in pairs]


@pytest.mark.parametrize("length", LENGTHS)
def test_encode_planes_matches_pallas_and_lax(length):
    rows = random_rows(N, length, seed=200 + length)
    got = K.plain_encode_planes(torch.from_numpy(rows.copy()))
    assert got.dtype == torch.int64 and got.shape == (N,)
    for want in jax_planes_words(rows):
        assert np.array_equal(got.numpy().view(np.uint64), want)
    assert torch.equal(K.encode_planes(torch.from_numpy(rows.copy())), got)


@pytest.mark.parametrize("length", LENGTHS)
def test_decode_planes_matches_pallas_and_lax(length):
    rng = np.random.default_rng(300 + length)
    # arbitrary words: bits above 2L must be ignored
    words = rng.integers(0, 1 << 64, size=N, dtype=np.uint64)
    pair = jnp.asarray(JC.words_to_pair(words))
    got = K.decode_planes(torch.from_numpy(words.view(np.int64).copy()), length)
    assert got.dtype == torch.uint8 and got.shape == (N, length)
    for want in (JP.decode_planes(pair, length, tile_n=256, interpret=True),
                 JC.lax_decode_planes(pair, length)):
        assert np.array_equal(got.numpy(), JC.planes_to_rows(np.asarray(want)))
    assert torch.equal(K.plain_decode_planes(torch.from_numpy(words.view(np.int64)), length), got)


def test_planes_bit63_and_lowercase():
    t32 = np.full((N, 32), ord("T"), dtype=np.uint8)
    got = K.encode_planes(torch.from_numpy(t32))
    assert bool((got == -1).all())  # every bit set, bit 63 included
    assert all(bool((w == np.uint64((1 << 64) - 1)).all()) for w in jax_planes_words(t32))
    lower = random_rows(N, 12, seed=9, lowercase=True)
    upper = np.frombuffer(bytes(lower).upper(), dtype=np.uint8).reshape(lower.shape)
    got = K.encode_planes(torch.from_numpy(lower.copy()))
    assert torch.equal(got, K.encode_planes(torch.from_numpy(upper.copy())))
    for want in jax_planes_words(lower):
        assert np.array_equal(got.numpy().view(np.uint64), want)
    assert np.array_equal(K.decode_planes(got, 12).numpy(), upper)


@pytest.mark.parametrize("length", [0, 33])
def test_planes_length_error_text_matches(length):
    rows = np.full((4, length), ord("A"), dtype=np.uint8)
    with pytest.raises(ValueError) as jax_err:
        JP.encode_planes(jnp.asarray(JC.rows_to_planes(rows)), tile_n=256, interpret=True)
    with pytest.raises(ValueError) as torch_err:
        K.encode_planes(torch.from_numpy(rows))
    assert str(torch_err.value) == str(jax_err.value) == f"base count {length} outside 1..=32"
    with pytest.raises(ValueError) as jax_err:
        JP.decode_planes(jnp.zeros((2, 4), jnp.uint32), length, interpret=True)
    with pytest.raises(ValueError) as torch_err:
        K.decode_planes(torch.zeros(4, dtype=torch.int64), length)
    assert str(torch_err.value) == str(jax_err.value)


SALTS = [1, 0xA5A5A5A5, 0xFFFFFFFF]


@pytest.mark.parametrize("salt", SALTS)
def test_salted_records_match_pallas(salt):
    bc_rows = random_rows(N, 16, seed=21)
    umi_rows = random_rows(N, 12, seed=22)
    idx = random_index(N, seed=23)
    soa = JP.encode_records(
        jnp.asarray(JC.rows_to_planes(bc_rows)),
        jnp.asarray(JC.rows_to_planes(umi_rows)),
        jnp.asarray(JC.words_to_pair(idx)),
        tile_n=128,
        interpret=True,
        salt=jnp.uint32(salt),
    )
    got = K.encode_records(*torch_inputs(bc_rows, umi_rows, idx), salt=salt)
    assert torch.equal(got, records_from_jax_soa(np.asarray(soa)))
    assert torch.equal(got, K.plain_encode_records(*torch_inputs(bc_rows, umi_rows, idx), salt))
    bc_p, umi_p, idx_pair = JP.decode_records(
        soa, 16, 12, tile_n=128, interpret=True, salt=jnp.uint32(salt)
    )
    bc, umi, back = K.decode_records(got, 16, 12, salt=salt)
    assert np.array_equal(bc.numpy(), JC.planes_to_rows(np.asarray(bc_p)))
    assert np.array_equal(umi.numpy(), JC.planes_to_rows(np.asarray(umi_p)))
    assert np.array_equal(back.numpy().view(np.uint64), JC.pair_to_words(np.asarray(idx_pair)))
    assert np.array_equal(back.numpy().view(np.uint64), idx)


def test_salt_none_and_zero_are_unsalted_and_range_checked():
    inputs = torch_inputs(random_rows(N, 16, seed=24), random_rows(N, 12, seed=25),
                          random_index(N, seed=26))
    plain = K.encode_records(*inputs)
    for salt in (None, 0):
        assert torch.equal(K.encode_records(*inputs, salt=salt), plain)
        assert all(torch.equal(a, b) for a, b in
                   zip(K.decode_records(plain, 16, 12, salt), K.decode_records(plain, 16, 12)))
    for salt in (-1, 1 << 32):
        with pytest.raises(ValueError, match="salt"):
            K.encode_records(*inputs, salt=salt)
        with pytest.raises(ValueError, match="salt"):
            K.decode_records(plain, 16, 12, salt=salt)
