"""2-bit nucleotide codec: the host numpy reference.

Format contract (shared with :mod:`ibu_tpu.ops.codec`): A=00, C=01, G=10,
T=11, base *i* at bits ``2i`` of the packed word, at most 32 bases per u64.
Encoding is ``t = (c >> 1) & 3; code = t ^ (t >> 1)``, case-insensitive and
total; decoding gives uppercase ASCII.

The numpy functions (with the host API :func:`encode_seqs` /
:func:`decode_seqs`) are copies of the host-only part of
:mod:`ibu_tpu.ops.codec`, which cannot be imported here because it loads jax;
their error texts are kept byte for byte. The module imports no torch: the
plain torch codec is :func:`ibu_tpu_torch.ops.codec_cuda.torch_pack` and
:func:`~ibu_tpu_torch.ops.codec_cuda.torch_unpack`, beside the kernels.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# numpy reference (host)
# ---------------------------------------------------------------------------


def np_encode_codes(ascii_arr: np.ndarray) -> np.ndarray:
    """ASCII uint8 → 2-bit codes (same shape)."""
    t = (ascii_arr >> 1) & 3
    return t ^ (t >> 1)


def np_decode_ascii(codes: np.ndarray) -> np.ndarray:
    """2-bit codes → uppercase ASCII uint8 (same shape)."""
    codes = codes.astype(np.uint8)
    return (
        65 + 2 * codes + 2 * (codes >> 1) + 11 * (codes & (codes >> 1))
    ).astype(np.uint8)


#: 256-entry validity table: one gather and ``all()``.
_VALID_LUT = np.zeros(256, dtype=bool)
_VALID_LUT[[ord(c) for c in "ACGTacgt"]] = True


def np_validate_ascii(ascii_arr: np.ndarray) -> None:
    """Raise ``ValueError`` naming the first invalid character."""
    ok = _VALID_LUT[ascii_arr]
    if not ok.all():
        bad = np.argwhere(~ok)
        pos = tuple(int(v) for v in bad[0])
        ch = int(ascii_arr[pos])
        raise ValueError(
            f"invalid nucleotide {chr(ch)!r} (0x{ch:02x}) at position {pos}; "
            "expected one of ACGTacgt"
        )


def np_pack(ascii_rows: np.ndarray, validate: bool = False) -> np.ndarray:
    """``(N, L)`` ASCII → ``(N,)`` uint64 packed words (host reference)."""
    if validate:
        np_validate_ascii(ascii_rows)
    codes = np_encode_codes(ascii_rows).astype(np.uint64)
    L = ascii_rows.shape[1]
    shifts = (2 * np.arange(L, dtype=np.uint64))[None, :]
    return np.bitwise_or.reduce(codes << shifts, axis=1)


def np_unpack(words: np.ndarray, length: int) -> np.ndarray:
    """``(N,)`` uint64 → ``(N, L)`` uppercase ASCII (host reference)."""
    shifts = (2 * np.arange(length, dtype=np.uint64))[None, :]
    codes = (words[:, None] >> shifts) & np.uint64(3)
    return np_decode_ascii(codes)


def seqs_to_rows(seqs: list[str]) -> np.ndarray:
    """List of equal-length sequences → ``(N, L)`` ASCII uint8."""
    if not seqs:
        return np.zeros((0, 0), dtype=np.uint8)
    L = len(seqs[0])
    for s in seqs:
        if len(s) != L:
            raise ValueError(f"ragged sequence lengths: {len(s)} != {L}")
    return np.frombuffer("".join(seqs).encode("ascii"), dtype=np.uint8).reshape(
        len(seqs), L
    )


def rows_to_seqs(rows: np.ndarray) -> list[str]:
    """``(N, L)`` ASCII uint8 → list of strings."""
    return [bytes(r).decode("ascii") for r in rows]


def encode_seqs(seqs: list[str], validate: bool = True) -> np.ndarray:
    """Sequences → packed uint64 words (host API, ≤32 bases each).

    >>> encode_seqs(["A", "C", "G", "T"]).tolist()
    [0, 1, 2, 3]
    >>> encode_seqs(["ACGT"]).tolist()  # base i at bits 2i: 0+4+32+192
    [228]
    >>> encode_seqs(["acgt"]).tolist() == encode_seqs(["ACGT"]).tolist()
    True
    """
    rows = seqs_to_rows(seqs)
    if rows.shape[1] > 32:
        raise ValueError(f"sequence length {rows.shape[1]} exceeds 32 bases")
    return np_pack(rows, validate=validate)


def decode_seqs(words: np.ndarray, length: int) -> list[str]:
    """Packed uint64 words → uppercase sequences of ``length`` bases.

    >>> import numpy as np
    >>> decode_seqs(np.array([228], dtype=np.uint64), 4)
    ['ACGT']
    """
    return rows_to_seqs(np_unpack(np.asarray(words, dtype=np.uint64), length))
