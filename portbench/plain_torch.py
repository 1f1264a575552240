"""Per-barcode counts in plain ``torch`` on the CPU: the plain reference of
the ``splitseq`` configuration's histogram, beside the numpy one of
:mod:`portbench.reference.plain`.

Written from the IBU format alone: a barcode is a record's first u64 word,
and barcodes order as unsigned integers. It imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

#: int64's sign bit: XOR with it maps unsigned order onto signed order
SIGN = torch.iinfo(torch.int64).min


def counts(barcodes: np.ndarray | torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Distinct barcodes in ascending unsigned order and the reads of each,
    as int64 CPU tensors; the keys hold the barcodes' u64 bits. ``barcodes``
    is a uint64 array or an int64 tensor of the same bits."""
    if isinstance(barcodes, np.ndarray):
        barcodes = torch.from_numpy(np.ascontiguousarray(barcodes, dtype=np.uint64).view(np.int64))
    keys, reads = torch.unique(barcodes.cpu() ^ SIGN, sorted=True, return_counts=True)
    return keys ^ SIGN, reads


def counts_dict(barcodes: np.ndarray | torch.Tensor) -> dict[int, int]:
    """:func:`counts` as ``{barcode: reads}`` with unsigned integer keys, the
    form the program's histograms return."""
    keys, reads = counts(barcodes)
    return dict(zip(keys.numpy().view(np.uint64).tolist(), reads.tolist()))
