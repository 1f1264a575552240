"""Deterministic patterned files whose field sums have closed forms.

Counterpart of :mod:`ibu_tpu.utils.datagen`, built on the port's
:class:`~ibu_tpu_torch.constructs.Header`, ``make_records`` and
:class:`~ibu_tpu_torch.io.Writer`: the same ``n`` and ``fields`` give the same
file bytes. The feed and stream labs (:mod:`ibu_tpu_torch.labs`) write their
input files with it. numpy only: importing it loads no torch.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from ibu_tpu_torch.constructs.header import Header
from ibu_tpu_torch.constructs.record import make_records
from ibu_tpu_torch.io.writer import Writer

CHUNK = 4 * 1024 * 1024


def parallel_fields(i: np.ndarray):
    """barcode = i mod 1M, umi = 2i, index = i (the parallel-harness pattern:
    index sums to n(n-1)/2)."""
    return i % np.uint64(1_000_000), i * np.uint64(2), i


def roundtrip_fields(i: np.ndarray):
    """barcode = i mod 1M, umi = 31i mod 1M, index = i (the reference
    roundtrip pattern, ``examples/roundtrip.rs:33-39``)."""
    return (
        i % np.uint64(1_000_000),
        (i * np.uint64(31)) % np.uint64(1_000_000),
        i,
    )


def write_patterned_file(
    path: str,
    n: int,
    fields: Callable[[np.ndarray], tuple] = parallel_fields,
    header: Header | None = None,
    sorted_flag: bool = False,
    chunk: int = CHUNK,
) -> None:
    """Write ``n`` records whose fields are ``fields(arange-chunk)``."""
    if header is None:
        header = Header.new(16, 12)
    if sorted_flag:
        header.set_sorted()
    with Writer.from_path(path, header) as w:
        for s in range(0, n, chunk):
            m = min(chunk, n - s)
            i = np.arange(s, s + m, dtype=np.uint64)
            bc, umi, idx = fields(i)
            w.write_batch(make_records(bc, umi, idx))
