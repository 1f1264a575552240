"""One module a kind of job, named as the traffic file's ``job`` names it.

Each module holds:

* ``LIMITS``: the numbers its comparison gives, each with its limit;
* ``prepare(ctx)``: the job's inputs from the generator and anything the
  call needs (a file), as a state dict with ``records_per_job`` and
  ``distinct`` (the number of distinct inputs the jobs cycle over);
* ``run(state, i)``: job ``i``, the timed call into the program, returning
  its output in host memory;
* ``reference(state)``: the plain reference's answers, worked out again from
  the inputs (:mod:`portbench.reference.plain`);
* ``compare(state, ref, kept)``: the numbers of ``LIMITS`` over the kept
  ``(i, output)`` pairs;
* ``control(state)``: the reference put in the program's place with one of
  the configuration's guarantees broken, as ``(i, output)`` pairs that
  ``compare`` takes; the benchmark's own runs never call it.
"""

from __future__ import annotations

import numpy as np


def rows_wrong(got: np.ndarray, expected: np.ndarray) -> int:
    """Rows of ``got`` that differ from ``expected``'s, a missing or extra row
    counting as one; every row where the widths differ."""
    got = np.asarray(got).reshape(len(got), -1)
    expected = np.asarray(expected).reshape(len(expected), -1)
    if got.shape[1] != expected.shape[1] or got.dtype.itemsize != expected.dtype.itemsize:
        return max(len(got), len(expected))
    n = min(len(got), len(expected))
    diff = (got[:n].view(expected.dtype) != expected[:n]).any(axis=1)
    return int(diff.sum()) + abs(len(got) - len(expected))


def words(records: np.ndarray) -> np.ndarray:
    """Structured 24-byte records → ``(N, 3)`` uint64 view."""
    return np.ascontiguousarray(records).view(np.uint64).reshape(-1, 3)


def ibu_header(bc_len: int, umi_len: int) -> bytes:
    """The 32-byte header of an unsorted IBU file of these widths."""
    from ibu_tpu_torch.constructs.header import Header

    return Header.new(bc_len, umi_len).as_bytes()
