"""Plain numpy answers for the benchmark's jobs.

The 2-bit table is the format's own (``src/constructs/record.rs:19-27`` of
the IBU crate): A=00, C=01, G=10, T=11, base ``i`` of a field at bits
``2i`` of its little-endian u64 word. A record is three such words,
``barcode``, ``umi`` and ``index``, and records order lexicographically by
the three as unsigned integers.
"""

from __future__ import annotations

import numpy as np

#: the format's table, read as ASCII code → 2-bit code (upper case only:
#: the benchmark's rows are upper case)
BASE_CODE = {ord("A"): 0, ord("C"): 1, ord("G"): 2, ord("T"): 3}

_CODE_OF = np.zeros(256, dtype=np.uint8)
for _ch, _code in BASE_CODE.items():
    _CODE_OF[_ch] = _code


def pack(rows: np.ndarray, table: np.ndarray = _CODE_OF) -> np.ndarray:
    """``(N, L)`` ASCII rows, ``L <= 32`` → ``(N,)`` uint64 words. Four
    bases make one byte (base ``4j + m`` at bits ``2m`` of byte ``j``), and
    the bytes are the word's, least significant first."""
    n, length = rows.shape
    codes = np.zeros((n, 32), dtype=np.uint8)
    codes[:, :length] = table[rows]
    quads = codes.reshape(n, 8, 4)
    packed = quads[:, :, 0] | (quads[:, :, 1] << 2) | (quads[:, :, 2] << 4) | (quads[:, :, 3] << 6)
    return np.ascontiguousarray(packed).view("<u8").reshape(n)


def unpack(words: np.ndarray, length: int, letters: bytes = b"ACGT") -> np.ndarray:
    """``(N,)`` uint64 words → ``(N, length)`` upper-case ASCII rows, code
    ``c`` read as ``letters[c]``."""
    letters = np.frombuffer(letters, dtype=np.uint8)
    shifts = 2 * np.arange(length, dtype=np.uint64)
    return letters[((words[:, None] >> shifts) & np.uint64(3)).astype(np.intp)]


def records(barcode: np.ndarray, umi: np.ndarray, index: np.ndarray) -> np.ndarray:
    """``(N, 3)`` uint64 matrix of the three words, the bytes of N records."""
    return np.stack([barcode, umi, index], axis=1).astype(np.uint64, copy=False)


def sums(words: np.ndarray) -> dict:
    """Count and the three field sums of an ``(N, 3)`` uint64 matrix, taken
    mod 2^64 (numpy's uint64 sum wraps)."""
    total = words.sum(axis=0, dtype=np.uint64)
    return {"count": int(words.shape[0]), "barcode_sum": int(total[0]),
            "umi_sum": int(total[1]), "index_sum": int(total[2])}


def sort(words: np.ndarray) -> np.ndarray:
    """Rows of an ``(N, 3)`` uint64 matrix in unsigned lexicographic order
    of (barcode, umi, index)."""
    return words[np.lexsort((words[:, 2], words[:, 1], words[:, 0]))]


def counts(barcodes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Distinct barcodes in ascending order and the reads of each."""
    return np.unique(barcodes, return_counts=True)
