"""The port's ``RecordLoader`` (``ibu_tpu_torch.data``) against the JAX
package's (``ibu_tpu.data``), exact.

Host batches must be the same records in the same order for every shuffle
mode, seed, shard split, block size and ``drop_remainder``; ``epoch()`` on
``device="cpu"`` must carry the same bytes as ``(B, 3)`` int64 tensors, with a
ragged tail where the JAX package pads and masks; the errors must have the
reference's texts.
"""

import numpy as np
import pytest
import torch

from ibu_tpu import Header as JHeader
from ibu_tpu import Writer as JWriter
from ibu_tpu.constructs.record import make_records
from ibu_tpu.data import RecordLoader as JLoader
from ibu_tpu_torch import MmapReader
from ibu_tpu_torch.data import RecordLoader
from ibu_tpu_torch.ops.u64 import wire_view

N = 10_007  # a ragged tail for every batch size below


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("data") / "train.ibu")
    rng = np.random.default_rng(21)
    with JWriter.from_path(p, JHeader.new(16, 12)) as w:
        w.write_batch(make_records(
            rng.integers(0, 1 << 32, N).astype(np.uint64),
            rng.integers(0, 1 << 24, N).astype(np.uint64),
            np.arange(N, dtype=np.uint64) | np.uint64(1 << 63),
        ))
    return p


def _same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("drop", [True, False])
@pytest.mark.parametrize("shards", [(0, 1), (0, 3), (2, 3)])
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("shuffle", [False, True, "global", "blocks"])
def test_host_batches_equal_jax(path, shuffle, seed, shards, drop):
    kwargs = dict(shuffle=shuffle, seed=seed, shard_index=shards[0], shard_count=shards[1],
                  drop_remainder=drop, block_records=1000, to_device=False)
    got, want = RecordLoader(path, 512, **kwargs), JLoader(path, 512, **kwargs)
    assert (len(got), got.records) == (len(want), want.records)
    for epoch in (0, 1):
        _same_batches(got.host_batches(epoch), want.host_batches(epoch))
    _same_batches(got.epochs(2), want.epochs(2))
    _same_batches(iter(got), iter(want))


@pytest.mark.parametrize("shuffle", [False, "global", "blocks"])
def test_epoch_on_the_cpu_carries_the_host_batches(path, shuffle):
    """``epoch()`` yields ``(B, 3)`` int64 tensors of the host batches'
    bytes; with ``drop_remainder=False`` the last is the ragged tail."""
    kw = dict(shuffle=shuffle, seed=3, block_records=2048)
    loader = RecordLoader(path, 1024, drop_remainder=False, device="cpu", **kw)
    host = list(JLoader(path, 1024, drop_remainder=False, to_device=False, **kw).host_batches(1))
    dev = list(loader.epoch(1))
    assert len(dev) == len(host) == -(-N // 1024)
    for t, want in zip(dev, host):
        assert isinstance(t, torch.Tensor) and t.dtype == torch.int64 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), wire_view(np.asarray(want)))
    assert dev[-1].shape == (N % 1024, 3)
    every = torch.cat(dev).numpy()
    np.testing.assert_array_equal(np.sort(every[:, 2]),  # a permutation of the file
                                  np.sort(wire_view(MmapReader(path).records)[:, 2]))


def test_iterating_the_loader_is_epoch_zero_on_the_device(path):
    loader = RecordLoader(path, 4096, shuffle=True, device="cpu")
    want = JLoader(path, 4096, shuffle=True, to_device=False).host_batches(0)
    got = list(loader)
    assert [t.shape for t in got] == [(4096, 3)] * 2  # the tail is dropped
    for t, w in zip(got, want):
        np.testing.assert_array_equal(t.numpy(), wire_view(np.asarray(w)))


def test_shards_are_disjoint_and_exact(path):
    seen = []
    for k in range(3):
        loader = RecordLoader(path, 100, shuffle="blocks", seed=1, shard_index=k,
                              shard_count=3, drop_remainder=False, to_device=False)
        seen.append(np.concatenate(list(loader.host_batches())))
    idx = np.concatenate([s["index"] for s in seen])
    assert len(idx) == N and len(np.unique(idx)) == N


def test_a_reader_is_accepted(path):
    got = RecordLoader(MmapReader(path), 999, to_device=False)
    _same_batches(got.host_batches(), JLoader(path, 999, to_device=False).host_batches())
    assert got.header().as_bytes() == JLoader(path, 999).header().as_bytes()


@pytest.mark.parametrize("args,kwargs", [
    ((0,), {}),
    ((10,), {"shuffle": "banana"}),
    ((10,), {"shard_index": 2, "shard_count": 2}),
    ((10,), {"shard_index": -1}),
])
def test_bad_arguments_raise_the_reference_texts(path, args, kwargs):
    with pytest.raises(ValueError) as want:
        JLoader(path, *args, **kwargs)
    with pytest.raises(ValueError) as got:
        RecordLoader(path, *args, **kwargs)
    assert str(got.value) == str(want.value)


def test_a_compressed_file_is_refused_like_jax(tmp_path):
    p = str(tmp_path / "z.ibu.gz")
    i = np.arange(100, dtype=np.uint64)
    with JWriter.from_path(p, JHeader.new(8, 6), compression="auto") as w:
        w.write_batch(make_records(i, i, i))
    with pytest.raises(ValueError) as want:
        JLoader(p, batch_records=10)
    with pytest.raises(ValueError) as got:
        RecordLoader(p, batch_records=10)
    assert str(got.value) == str(want.value).replace("python -m ibu_tpu ",
                                                     "python -m ibu_tpu_torch ")


def test_an_empty_file(tmp_path):
    p = str(tmp_path / "e.ibu")
    with JWriter.from_path(p, JHeader.new(4, 4)):
        pass
    loader = RecordLoader(p, 8, shuffle="blocks", device="cpu")
    assert len(loader) == 0 and list(loader.host_batches()) == [] and list(loader.epoch()) == []
