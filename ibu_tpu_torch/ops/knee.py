"""Cell calling: knee detection on the barcode rank-count curve.

Single-cell workflows decide which barcodes are real cells (vs ambient
noise) from the log-log curve of per-barcode read counts sorted descending:
real cells sit on a high plateau, ambient barcodes on a low tail, and the
transition is a sharp "knee". Two closed-form methods:

* ``knee``   — maximum distance below the chord of the log-log curve. No
  parameters.
* ``ordmag`` — order-of-magnitude rule: the 99th-percentile count of the top
  ``expect`` barcodes, keeping everything within 10x of it.

Both return an integer **count threshold** with the rule "a barcode is a
cell iff ``count >= threshold``".

The numpy functions are copies of :mod:`ibu_tpu.ops.knee` (which cannot be
imported here: the port loads no module of the JAX package).
:func:`torch_knee_index` is the counterpart of its ``lax_knee_index``: the
same float32 curve on a given device. As in the JAX package, production
(:func:`call_from_counts`) uses the numpy form.
"""

from __future__ import annotations

import numpy as np
import torch

from ibu_tpu_torch.utils.device import resolve_device

__all__ = [
    "np_knee_index",
    "torch_knee_index",
    "knee_threshold",
    "ordmag_threshold",
    "call_from_counts",
]


def _chord_deviation(x, y):
    """Signed area-deviation of each point from the first→last chord
    (negative = below it): ``(x1-x0)*(y_i-y0) - (y1-y0)*(x_i-x0)``. Works
    the same on numpy arrays and torch tensors."""
    return (x[-1] - x[0]) * (y - y[0]) - (y[-1] - y[0]) * (x - x[0])


def np_knee_index(counts_desc: np.ndarray) -> int:
    """Index of the knee of a descending count curve (numpy oracle).

    The knee is the point of maximum deviation *below* the chord joining the
    first and last points of the ``(log10 rank, log10 count)`` curve — for a
    cells-plateau / cliff / ambient-tail shape, the first barcode past the
    cliff.

    Degenerate curves (fewer than 3 points, or flat) have no knee; returns
    ``len(counts)``, meaning "everything is above the knee". Counts must be
    positive — raises ``ValueError`` otherwise.
    """
    counts_desc = np.asarray(counts_desc)
    n = len(counts_desc)
    if n and counts_desc[-1] <= 0:
        raise ValueError(
            "counts must be positive (drop zero-count barcodes first)"
        )
    if n < 3 or counts_desc[0] == counts_desc[-1]:
        return n
    x = np.log10(np.arange(1, n + 1, dtype=np.float64))
    y = np.log10(counts_desc.astype(np.float64))
    dev = _chord_deviation(x, y)
    k = int(np.argmin(dev))
    if dev[k] >= 0:  # concave curve (plateau ending in a cliff): no knee
        return n
    return k


def torch_knee_index(
    counts_desc, device: str | torch.device | None = None
) -> torch.Tensor:
    """Torch twin of :func:`np_knee_index` on ``device``: a 0-d int64 tensor
    there, so a device-resident composition does not wait on the host.

    Same contract, with the caveats of the JAX package's ``lax_knee_index``:
    counts are assumed positive (no check, which would wait on the device),
    and the curve is computed in float32, so above about 2M barcodes
    adjacent ranks collapse to one x ulp and the argmin can land a few ranks
    away from the float64 numpy oracle.
    """
    device = resolve_device(device)
    counts_desc = torch.as_tensor(counts_desc, device=device)
    n = counts_desc.shape[0]
    if n < 3:
        return torch.tensor(n, dtype=torch.int64, device=device)
    x = torch.log10(torch.arange(1, n + 1, dtype=torch.float32, device=device))
    y = torch.log10(counts_desc.to(torch.float32))
    dev = _chord_deviation(x, y)
    k = torch.argmin(dev)
    no_knee = (counts_desc[0] == counts_desc[-1]) | (dev[k] >= 0)
    return torch.where(no_knee, n, k)


def knee_threshold(counts_desc: np.ndarray) -> int:
    """Count threshold from the knee: cells are strictly above the knee
    point's count (the knee itself is the top of the ambient tail)."""
    counts_desc = np.asarray(counts_desc)
    k = np_knee_index(counts_desc)
    if k >= len(counts_desc):  # degenerate: everything is a cell
        return int(counts_desc[-1]) if len(counts_desc) else 1
    return int(counts_desc[k]) + 1


def ordmag_threshold(counts_desc: np.ndarray, expect: int = 3000) -> int:
    """Order-of-magnitude threshold: 99th-percentile count of the top
    ``expect`` barcodes, divided by 10 (floor 1)."""
    counts_desc = np.asarray(counts_desc)
    if len(counts_desc) == 0:
        return 1
    top = counts_desc[: max(1, min(expect, len(counts_desc)))]
    m = float(np.quantile(top.astype(np.float64), 0.99))
    return max(1, int(np.ceil(m / 10.0)))


def call_from_counts(
    barcodes: np.ndarray,
    counts: np.ndarray,
    method: str = "knee",
    expect: int = 3000,
    min_count: int = 1,
) -> tuple[np.ndarray, int]:
    """Call cells from an (unsorted) barcode/count table.

    Returns ``(cell_barcodes_desc, threshold)``: the barcodes whose count is
    ``>= max(threshold, min_count)``, ordered by descending count (ties
    broken by ascending barcode). Zero-count rows are dropped up front;
    negative counts raise.
    """
    barcodes = np.asarray(barcodes, dtype=np.uint64)
    counts = np.asarray(counts, dtype=np.int64)
    if barcodes.shape != counts.shape:
        raise ValueError(
            f"barcodes {barcodes.shape} vs counts {counts.shape}"
        )
    if np.any(counts < 0):
        raise ValueError("counts must be nonnegative")
    nz = counts > 0
    if not nz.all():
        barcodes, counts = barcodes[nz], counts[nz]
    # descending count, ascending barcode within ties: lexsort is
    # last-key-primary, so sort by (barcode asc, -count asc).
    order = np.lexsort((barcodes, -counts))
    barcodes, counts = barcodes[order], counts[order]
    if method == "knee":
        threshold = knee_threshold(counts)
    elif method == "ordmag":
        threshold = ordmag_threshold(counts, expect=expect)
    else:
        raise ValueError(f"unknown method {method!r} (knee|ordmag)")
    threshold = max(int(threshold), int(min_count))
    n_cells = int(np.searchsorted(-counts, -threshold, side="right"))
    return barcodes[:n_cells], threshold
