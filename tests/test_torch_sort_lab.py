"""The sort lab of the torch port against the TPU lab's own kernels, on the CPU.

``tools/pallas_sort_lab.py`` is imported by path and its ``pl`` module is
replaced by the ``Interpret`` stand-in of ``tests/test_torch_labs.py``, so
its three Pallas kernels run in interpret mode. The same keys (the lab's
formula, as uint32) and offsets go through them and through the port's plain
versions and its wrappers, which run the plain versions for CPU tensors and
launch nothing. Outputs are integers and must agree exactly. 16384 keys (8
tiles) keep the interpret-mode runs to a few seconds. The edge cases hold
the plain versions to the numpy oracles of :mod:`ibu_tpu_torch.labs.sort_lab`,
and, where every output row is written, to the Pallas kernels too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibu_tpu_torch.labs import _sort_kernels as K
from ibu_tpu_torch.labs import sort_lab as L
from tests.test_torch_labs import interpreted, load_tpu_lab

CPU = torch.device("cpu")
N = K.KEYS_MULTIPLE  # 8 tiles: one grid step of the TPU histogram


@pytest.fixture(scope="module")
def tpu_lab():
    return load_tpu_lab("pallas_sort_lab")


def lab_keys(n, seed):
    """The TPU lab's key formula (``tools/pallas_sort_lab.py:204-206``), as uint32."""
    i = np.arange(n, dtype=np.uint32)
    return (i * np.uint32(2654435761)) ^ (i >> np.uint32(3)) ^ np.uint32(seed)


def as_port(keys_u32):
    return torch.from_numpy(np.ascontiguousarray(keys_u32).view(np.int32))


@pytest.fixture(scope="module")
def interpreted_outputs(tpu_lab):
    """The Pallas kernels in interpret mode on the seed-0 keys and the lab's
    offsets; keys 100-102 and the ``(0, 8)`` offsets for the store too."""
    mp = pytest.MonkeyPatch()
    try:
        shim = interpreted(tpu_lab, mp)
        keys = lab_keys(N, 0)
        offs = L.make_offsets(N // K.TILE)
        out = {
            "hist": np.asarray(tpu_lab.digit_histogram(jnp.asarray(keys), interpret=False)),
            "rank": np.asarray(tpu_lab.rank_cumsum(jnp.asarray(keys), interpret=False)),
            "store": np.asarray(tpu_lab.dynamic_store(jnp.asarray(keys), jnp.asarray(offs),
                                                      interpret=False)),
        }
        other = L.case_offsets(N // K.TILE, "8 then 0")
        out["store_8_0"] = np.asarray(tpu_lab.dynamic_store(
            jnp.asarray(lab_keys(N, 101)), jnp.asarray(other), interpret=False))
        out["calls"] = len(shim.outputs)
        return out
    finally:
        mp.undo()


def test_the_stand_in_ran_every_kernel(interpreted_outputs):
    assert interpreted_outputs["calls"] == 4


def test_keys_and_offsets_follow_the_tpu_lab():
    for seed in (0, 100, 0xFFFFFFFF):
        got = L.make_keys(N, seed, CPU).numpy().view(np.uint32)
        assert np.array_equal(got, lab_keys(N, seed))
    tiles = 3 * 8
    offs = L.make_offsets(tiles)
    want = (np.random.default_rng(0).permutation(tiles * 256) % 9).reshape(tiles, 256)
    assert offs.shape == (tiles * 8, 128) and offs.dtype == np.int32
    assert np.array_equal(offs.reshape(tiles, 1024)[:, :256], want)
    assert not offs.reshape(tiles, 1024)[:, 256:].any()


@pytest.mark.parametrize("port", ["plain", "wrapper"])
def test_digit_histogram_matches_pallas(interpreted_outputs, port):
    keys = as_port(lab_keys(N, 0))
    got = (K.plain_digit_histogram if port == "plain" else K.digit_histogram)(keys)
    want = interpreted_outputs["hist"]
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape == (8, 256)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, L.np_digit_histogram(lab_keys(N, 0)))


@pytest.mark.parametrize("port", ["plain", "wrapper"])
def test_rank_cumsum_matches_pallas(interpreted_outputs, port):
    keys = as_port(lab_keys(N, 0))
    got = (K.plain_rank_cumsum if port == "plain" else K.rank_cumsum)(keys)
    want = interpreted_outputs["rank"]
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape == (N // 128, 128)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want.reshape(-1)[:K.TILE], L.np_rank_sequential(lab_keys(K.TILE, 0)))


@pytest.mark.parametrize("port", ["plain", "wrapper"])
def test_dynamic_store_matches_pallas(interpreted_outputs, port):
    fn = K.plain_dynamic_store if port == "plain" else K.dynamic_store
    keys = as_port(lab_keys(N, 0))
    offs = torch.from_numpy(L.make_offsets(N // K.TILE))
    got = fn(keys, offs)
    want = interpreted_outputs["store"]
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape == (N // 128, 128)
    assert np.array_equal(got.numpy(), want)
    other = torch.from_numpy(L.case_offsets(N // K.TILE, "8 then 0"))
    assert np.array_equal(fn(as_port(lab_keys(N, 101)), other).numpy(),
                          interpreted_outputs["store_8_0"])


# ---------------------------------------------------------------------------
# edge cases, against the numpy oracles
# ---------------------------------------------------------------------------


def edge_keys():
    base = lab_keys(2 * N, 7)
    every = np.tile(np.arange(256, dtype=np.uint32)[::-1] * np.uint32(0x01010101), 2 * N // 256)
    return {
        "one digit": (base & np.uint32(0xFFFFFF00)) | np.uint32(0x5A),
        "every digit in every tile": every,
        "extreme values": np.where(np.arange(2 * N) % 2 == 0, 0, 0xFFFFFFFF).astype(np.uint32),
        "lab keys": base,
    }


@pytest.mark.parametrize("case", list(edge_keys()))
def test_histogram_and_rank_edges(case):
    keys = edge_keys()[case]
    hist = K.digit_histogram(as_port(keys)).numpy()
    assert np.array_equal(hist, L.np_digit_histogram(keys))
    assert (hist.sum(axis=1) == K.TILE).all()
    rank = K.rank_cumsum(as_port(keys)).numpy().reshape(-1)
    assert np.array_equal(rank, L.np_rank(keys))
    for t in (0, 2 * N // K.TILE - 1):
        tile = slice(t * K.TILE, (t + 1) * K.TILE)
        assert np.array_equal(rank[tile], L.np_rank_sequential(keys[tile]))
    if case == "one digit":
        assert (hist[:, 0x5A] == K.TILE).all()
        assert np.array_equal(rank.reshape(-1, K.TILE), np.tile(np.arange(K.TILE), (2 * N // K.TILE, 1)))
    if case == "every digit in every tile":
        assert (hist == K.TILE // 256).all()


def ordered_stores(keys, offs, tiles):
    """The stores one at a time, in order, skipping offsets outside [0, 8]."""
    out = np.zeros((tiles, 16, 128), keys.dtype)
    for t in range(tiles):
        for c in range(256):
            start = int(offs[8 * t + c // 128, c % 128])
            if 0 <= start <= 8:
                g = c % 2
                out[t, start:start + 8] = keys.reshape(tiles, 16, 128)[t, 8 * g:8 * g + 8]
    return out.reshape(-1, 128)


def copy_rows(keys, rows):
    """Each tile's output block from ``L.np_last_writers``' rows: key row
    ``rows[t, r]`` of tile ``t`` copied to output row ``r``, 0 for -1."""
    src = keys.reshape(len(rows), 16, 128)
    out = np.take_along_axis(src, np.maximum(rows, 0)[:, :, None], axis=1)
    out[rows < 0] = 0
    return out.reshape(-1, 128)


@pytest.mark.parametrize("offsets", L.STORE_CASES)
def test_dynamic_store_edges(offsets):
    tiles = 2 * N // K.TILE
    keys = lab_keys(2 * N, 9)
    offs = L.case_offsets(tiles, offsets)
    got = K.dynamic_store(as_port(keys), torch.from_numpy(offs)).numpy().view(np.uint32)
    want = L.np_dynamic_store(keys, offs)
    assert np.array_equal(got, want)
    blocks, src = got.reshape(tiles, 16, 128), keys.reshape(tiles, 16, 128)
    if offsets == "all 0":  # the last store (c = 255) is rows 8-15 at 0; 8-15 stay empty
        assert np.array_equal(blocks[:, :8], src[:, 8:]) and not blocks[:, 8:].any()
    if offsets == "0 then 8":  # every store lands on its own rows
        assert np.array_equal(blocks, src)
    if offsets == "8 then 0":
        assert np.array_equal(blocks[:, :8], src[:, 8:]) and np.array_equal(blocks[:, 8:], src[:, :8])
    if offsets == "all outside":
        assert not blocks.any()
    if offsets == "only store 0":  # rows 0-7 of the keys at store 0's offset, the rest empty
        start = offs.reshape(tiles, -1)[:, 0]
        for t in range(tiles):
            assert np.array_equal(blocks[t, start[t]:start[t] + 8], src[t, :8])
            assert not np.delete(blocks[t], np.arange(start[t], start[t] + 8), axis=0).any()


@pytest.mark.parametrize("offsets", L.STORE_CASES)
def test_last_writer_resolution_is_the_ordered_loop(offsets):
    """The card's K3 algorithm, stated in numpy (each output row's last
    covering store once per tile, then a copy of whole rows), against the
    stores made in order."""
    tiles = 8
    keys, offs = lab_keys(tiles * K.TILE, 11), L.case_offsets(tiles, offsets)
    rows = L.np_last_writers(offs)
    assert rows.shape == (tiles, 16) and rows.min() >= -1 and rows.max() <= 15
    got = copy_rows(keys, rows)
    assert np.array_equal(got, L.np_dynamic_store(keys, offs))
    assert np.array_equal(got, ordered_stores(keys, offs, tiles))


@pytest.mark.parametrize("offsets,rows_per_tile", [("all 0", 8), ("0 then 8", 16), ("halves", 8),
                                                   ("all outside", 0), ("only store 0", 8)])
def test_k3_bound_counts_the_rows_the_offsets_select(offsets, rows_per_tile):
    tiles = 8
    offs = L.case_offsets(tiles, offsets)
    assert L.selected_rows(offs) == rows_per_tile * tiles
    n = tiles * K.TILE
    moved = L.bound_bytes(n, offs)[L.KERNEL_ROWS[2]]
    assert moved == 512 * rows_per_tile * tiles + 4 * n + 4 * 256 * tiles
    assert moved <= L.bound_bytes(n)[L.KERNEL_ROWS[2]]


@pytest.mark.parametrize("case", L.RANK_CASES)
@pytest.mark.parametrize("port", ["plain", "wrapper"])
def test_rank_cases_match_numpy(case, port):
    keys = L.case_keys(3 * N, case, CPU)
    host = keys.numpy().view(np.uint32)
    rank = (K.plain_rank_cumsum if port == "plain" else K.rank_cumsum)(keys).numpy().reshape(-1)
    assert np.array_equal(rank, L.np_rank(host))
    assert np.array_equal(rank[-K.TILE:], L.np_rank_sequential(host[-K.TILE:]))
    digits = (host & 0xFF).reshape(-1, K.TILE)
    if case == "one digit":
        assert rank.max() == K.TILE - 1
    if case == "every digit 8 times":
        assert (np.apply_along_axis(np.bincount, 1, digits, minlength=256) == 8).all()
    if case == "digit only in the last warp":
        assert not (digits[:, :K.TILE * 3 // 4] == 255).any()
        assert ((digits[:, K.TILE * 3 // 4:] == 255).sum(axis=1) > 100).all()


def test_dynamic_store_oracle_is_the_ordered_loop():
    """The vectorized numpy oracle against stores written one at a time."""
    tiles = 8
    keys, offs = lab_keys(tiles * K.TILE, 3), L.make_offsets(tiles)
    assert np.array_equal(L.np_dynamic_store(keys, offs), ordered_stores(keys, offs, tiles))


# ---------------------------------------------------------------------------
# checks of the wrappers, launch counters, the lab's entry point
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1000, K.TILE, N + K.TILE, N - 1])
def test_ragged_key_counts_raise(n):
    keys = torch.zeros(n, dtype=torch.int32)
    for fn in (K.digit_histogram, K.rank_cumsum, lambda k: K.dynamic_store(k, None)):
        with pytest.raises(ValueError, match="multiple of 16384"):
            fn(keys)


def test_wrapper_argument_checks():
    keys = as_port(lab_keys(N, 0))
    with pytest.raises(ValueError, match="int32"):
        K.rank_cumsum(keys.to(torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        K.digit_histogram(torch.zeros(2 * N, dtype=torch.int32)[::2])
    with pytest.raises(ValueError, match=r"offs must be \(64, 128\)"):
        K.dynamic_store(keys, torch.zeros((63, 128), dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        K.dynamic_store(keys, torch.zeros((64, 128), dtype=torch.int64))
    assert K.digit_histogram(torch.empty(0, dtype=torch.int32)).shape == (0, 256)


def test_cpu_tensors_launch_no_sort_kernel(monkeypatch):
    for kernel, _, _ in K.KERNELS.values():
        monkeypatch.setattr(kernel, "launches", 0)
    keys = as_port(lab_keys(N, 1))
    K.digit_histogram(keys)
    K.rank_cumsum(keys)
    K.dynamic_store(keys, torch.from_numpy(L.make_offsets(N // K.TILE)))
    assert {name: k.launches for name, (k, _, _) in K.KERNELS.items()} == dict.fromkeys(K.KERNELS, 0)
    assert set(K.KERNELS) == {"digit_histogram", "rank_cumsum", "dynamic_store"}
    assert [line for _, _, line in K.KERNELS.values()] == [
        "tools/pallas_sort_lab.py:88", "tools/pallas_sort_lab.py:141", "tools/pallas_sort_lab.py:173"]


def test_check_catches_a_wrong_kernel(monkeypatch):
    keys = L.make_keys(N, 0, CPU)
    offs = torch.from_numpy(L.make_offsets(N // K.TILE))
    assert L.check(keys, offs, log=lambda line: None) == []

    def first_wrong(out):
        flat = out.reshape(-1).clone()
        flat[0] += 1
        return flat.view(out.shape)

    monkeypatch.setattr(K, "rank_cumsum", lambda k: first_wrong(K.plain_rank_cumsum(k)))
    monkeypatch.setattr(K, "dynamic_store", lambda k, o: first_wrong(K.plain_dynamic_store(k, o)))
    assert L.check(keys, offs, log=lambda line: None) == ["rank_cumsum", "dynamic_store"]


def test_sorts_order_unsigned():
    keys = as_port(lab_keys(N, 5))
    want = np.sort(lab_keys(N, 5))
    assert np.array_equal(L.sort1(keys).numpy().view(np.uint32) ^ np.uint32(1 << 31), want)
    x = lab_keys(N, 5).astype(np.int64)
    order = np.lexsort((np.arange(N), (x * 40503) & 0xFFFFFF, x))
    assert np.array_equal(L.sort3(keys).numpy(), x[order])


def test_bounds_and_verdict():
    n = 1 << 24
    bounds = {name: L.bound_ms(b) for name, b in L.bound_bytes(n).items()}
    # 4.5, 8 and 8.5 B per key: K3 reads its 256 offsets per tile, not the padding
    assert [round(bounds[r], 4) for r in L.KERNEL_ROWS] == [0.0225, 0.0401, 0.0426]
    assert L.bound_bytes(n)[L.KERNEL_ROWS[2]] == 8 * n + n // 2
    rows = [{"name": name, "n": n, "ms": ms, "ms_min": ms, "bytes": L.bound_bytes(n)[name],
             "bound_ms": bounds[name]}
            for name, ms in zip([*L.KERNEL_ROWS, L.SORT1, L.SORT3], [0.1, 0.2, 0.3, 1.0, 6.0])]
    lines = L.report(rows)
    assert len(lines) == 7 and lines[0].split()[0] == "row"
    assert lines[-1].startswith("per-pass floor (max of K2/K3): 0.3000 ms; 4-pass radix >= 1.2000 ms")
    assert "radix is 1.20x the baseline" in lines[-1] and "0.20x the 3-key sort" in lines[-1]
    assert "a lower bound" in lines[-1] and "scatters every key" in lines[-1]


def test_lab_entry_point_on_cpu(capsys):
    assert L.main(["--device", "cpu", "--records", str(N)]) == 0
    out = capsys.readouterr().out
    assert out.count("oracle-exact") == 3 and "no timing" in out
    assert L.main(["--device", "cpu", "--records", "1000"]) == 2
    assert "multiple of 16384" in capsys.readouterr().out


def test_lab_without_a_card_exits_2(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert L.main(["--records", str(N)]) == 2
    assert "no CUDA card" in capsys.readouterr().out


def test_lab_reports_a_failed_check(monkeypatch, capsys):
    monkeypatch.setattr(K, "digit_histogram", lambda k: K.plain_digit_histogram(k) + 1)
    assert L.main(["--device", "cpu", "--records", str(N)]) == 1
    assert "digit_histogram: FAILED the oracle check" in capsys.readouterr().out
