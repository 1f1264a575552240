"""Training-facing batch loader: epochs, shuffling, sharding, prefetch.

Counterpart of :mod:`ibu_tpu.data`, with ``device=`` in place of ``mesh=``:

* **static batch shapes**: every batch has ``batch_records`` records with
  ``drop_remainder=True`` (the default); with ``drop_remainder=False`` the
  last batch of an epoch holds the remaining ``records % batch_records``
  records and is shorter (a ragged tail, no padding: the JAX package pads
  it and masks by valid counts, a torch consumer reads its length);
* **deterministic, seedable epoch shuffles**: ``(seed, epoch)`` keys a fresh
  permutation per epoch (``np.random.default_rng((seed, epoch))``), the JAX
  package's record for record, reproducible across runs and ranks;
* **I/O-aware shuffle modes**: ``"global"`` is a full permutation (random
  page reads through the mmap), ``"blocks"`` permutes block order and
  shuffles within blocks, keeping reads page-local for files much larger
  than RAM at a small mixing cost;
* **sharding**: contiguous per-shard record ranges by the reference
  partition rule (remainder to the last shard), so shard unions are exact
  and disjoint; a rank of a cohort passes ``shard_index=rank,
  shard_count=world size``;
* **device placement with prefetch**: batches ride
  :class:`ibu_tpu_torch.io.stream.DeviceStream` onto the card, arriving as
  ``(B, 3)`` int64 tensors in the wire layout.

Usage::

    loader = RecordLoader("train.ibu", batch_records=1 << 20,
                          shuffle="blocks", seed=7)
    for epoch in range(10):
        for records in loader.epoch(epoch):
            params = train_step(params, records)
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from ibu_tpu_torch.io.mmap import STREAM_PREFETCH, MmapReader


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class RecordLoader:
    """Epoch-based batch loader over an IBU file (see module docstring).

    ``shuffle``: ``False`` (sequential), ``True``/``"global"`` (full
    permutation), or ``"blocks"`` (permuted blocks of ``block_records``,
    shuffled within each block). ``device``: the card the batches go to
    (``None``: the current CUDA card; ``"cpu"`` only when asked for).
    ``to_device=False`` yields host structured-record batches instead (oracle
    and test path, and the tap for consumers off the device).
    """

    def __init__(
        self,
        path_or_reader: str | MmapReader,
        batch_records: int,
        *,
        shuffle: bool | str = False,
        seed: int = 0,
        drop_remainder: bool = True,
        shard_index: int = 0,
        shard_count: int = 1,
        block_records: int = 1 << 20,
        device=None,
        prefetch: int = STREAM_PREFETCH,
        to_device: bool = True,
    ):
        if batch_records < 1:
            raise ValueError(f"batch_records must be >= 1, got {batch_records}")
        if shuffle not in (False, True, "global", "blocks"):
            raise ValueError(
                f"shuffle must be False, True, 'global' or 'blocks', "
                f"got {shuffle!r}"
            )
        if not 0 <= shard_index < shard_count:
            raise ValueError(
                f"shard_index {shard_index} out of range for "
                f"shard_count {shard_count}"
            )
        if isinstance(path_or_reader, str):
            # mmap needs random access; a gzip/zstd input would otherwise
            # die with a misleading InvalidMagicNumber
            from ibu_tpu_torch.io.compression import sniff_compression

            with open(path_or_reader, "rb") as f:
                kind = sniff_compression(f.read(4))
            if kind is not None:
                raise ValueError(
                    f"{path_or_reader} is {kind}-compressed; RecordLoader "
                    "needs random access into the record region — "
                    "decompress it first (e.g. `python -m ibu_tpu_torch concat "
                    "out.ibu in.ibu.gz`)"
                )
        self._reader = (
            path_or_reader
            if isinstance(path_or_reader, MmapReader)
            else MmapReader(path_or_reader)
        )
        from ibu_tpu_torch.parallel.host import partition

        self._lo, self._hi = partition(len(self._reader), shard_count)[shard_index]
        self._batch = batch_records
        self._shuffle = "global" if shuffle is True else shuffle
        self._seed = seed
        self._drop = drop_remainder
        self._block = max(1, block_records)
        self._device = device
        self._prefetch = prefetch
        self._to_device = to_device

    # -- sizing -----------------------------------------------------------

    @property
    def records(self) -> int:
        """Records in this shard."""
        return self._hi - self._lo

    def __len__(self) -> int:
        """Batches per epoch."""
        n = self.records
        return n // self._batch if self._drop else _cdiv(n, self._batch)

    def header(self):
        return self._reader.header()

    # -- epoch machinery ----------------------------------------------------

    def _permutation(self, epoch: int) -> np.ndarray | None:
        """Shard-local record order for ``epoch`` (None = sequential)."""
        if not self._shuffle:
            return None
        rng = np.random.default_rng((self._seed, epoch))
        n = self.records
        if self._shuffle == "global":
            return rng.permutation(n)
        nblocks = _cdiv(n, self._block)
        parts = []
        for b in rng.permutation(nblocks):
            s, e = b * self._block, min((b + 1) * self._block, n)
            parts.append(s + rng.permutation(e - s))
        return np.concatenate(parts) if parts else np.empty(0, np.int64)

    def host_batches(self, epoch: int = 0) -> Iterator[np.ndarray]:
        """Structured-record host batches for one epoch."""
        perm = self._permutation(epoch)
        n = self.records
        shard = self._reader.slice(self._lo, self._hi) if n else None
        for k in range(len(self)):
            s = k * self._batch
            e = min(s + self._batch, n)
            if perm is None:
                # contiguous zero-copy view off the mapping
                yield shard[s:e]
            else:
                # fancy-index gather touches only the selected pages
                yield shard[perm[s:e]]

    def epoch(self, epoch: int = 0):
        """Iterate one epoch: ``(B, 3)`` int64 tensors on the card, copied
        ahead with prefetch, or host batches with ``to_device=False``."""
        if not self._to_device:
            return self.host_batches(epoch)
        from ibu_tpu_torch.io.stream import DeviceStream

        return DeviceStream(
            self.host_batches(epoch), device=self._device, prefetch=self._prefetch
        )

    def epochs(self, n_epochs: int):
        """Chain ``n_epochs`` epochs, reshuffling between them."""
        for ep in range(n_epochs):
            yield from self.epoch(ep)

    def __iter__(self):
        return iter(self.epoch(0))
