"""2-bit codec kernels: CUDA for Hopper and their plain torch versions.

The counterpart of :mod:`ibu_tpu.ops.codec_pallas`: the fused record codec
(``encode_records``, ``decode_records``) and the single-field codec
(``encode_planes``, ``decode_planes``). The kernels live in
``ibu_tpu_torch/csrc/codec.cu`` (built by :mod:`ibu_tpu_torch.ops._build`);
the source note there says what bounds them on the card and how they are
laid out.

A wrapper given CUDA tensors launches its kernel on the current stream and
raises if the launch fails; given CPU tensors it runs the plain version
beside it. There is no fallback from one to the other. Each wrapper counts
its kernel launches in its ``launches`` attribute.
"""

from __future__ import annotations

import torch

from ibu_tpu_torch.ops import _build
from ibu_tpu_torch.ops.u64 import to_signed


def _check_len(length: int, what: str) -> None:
    if not 1 <= length <= 32:
        raise ValueError(f"{what} {length} outside 1..=32")


def _check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(
            f"{name} must be a {ndim}-D {dtype} tensor, got {t.dim()}-D {t.dtype}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_device(device: torch.device, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device != device:
            raise ValueError(f"tensors on different devices: {device} and {t.device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}; expected cpu or cuda")


def _raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        msg = _build.load().ibu_cuda_error_string(rc).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc} ({msg})")


def _check_salt(salt: int | None) -> int:
    """The salt as the u32 the kernels take; ``None`` is 0."""
    if salt is None:
        return 0
    if not 0 <= salt < 1 << 32:
        raise ValueError(f"salt {salt} outside [0, 2^32)")
    return int(salt)


def _salt_word(salt: int | None) -> int:
    """The int64 the index is XORed with: the u32 ``salt`` in both halves."""
    salt = _check_salt(salt)
    return to_signed(salt | salt << 32)


# ---------------------------------------------------------------------------
# plain torch codec on rows: ``(N, L)`` uint8 ASCII and ``(N,)`` int64 words
# (the u64 bits), on any device
# ---------------------------------------------------------------------------


def torch_pack(rows: torch.Tensor) -> torch.Tensor:
    """``(N, L)`` uint8 ASCII → ``(N,)`` int64 packed words (u64 bits).

    The 2-bit fields are disjoint, so their sum is their bitwise or and never
    carries, bit 63 included.
    """
    t = (rows >> 1) & 3
    codes = (t ^ (t >> 1)).to(torch.int64)
    shifts = 2 * torch.arange(rows.shape[1], dtype=torch.int64, device=rows.device)
    return (codes << shifts).sum(dim=1)


#: code → uppercase ASCII.
_ASCII = (65, 67, 71, 84)


def torch_unpack(words: torch.Tensor, length: int) -> torch.Tensor:
    """``(N,)`` int64 words → ``(N, length)`` uppercase ASCII uint8."""
    shifts = 2 * torch.arange(length, dtype=torch.int64, device=words.device)
    codes = (words[:, None] >> shifts) & 3
    table = torch.tensor(_ASCII, dtype=torch.uint8, device=words.device)
    return table[codes]


def plain_encode_records(
    bc_rows: torch.Tensor,
    umi_rows: torch.Tensor,
    index: torch.Tensor,
    salt: int | None = None,
) -> torch.Tensor:
    """Plain torch version of :func:`encode_records`."""
    word = _salt_word(salt)
    index = index ^ word if word else index
    return torch.stack([torch_pack(bc_rows), torch_pack(umi_rows), index], dim=1)


def plain_decode_records(
    records: torch.Tensor, bc_len: int, umi_len: int, salt: int | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`decode_records`."""
    return (
        torch_unpack(records[:, 0], bc_len),
        torch_unpack(records[:, 1], umi_len),
        records[:, 2] ^ _salt_word(salt),
    )


def encode_records(
    bc_rows: torch.Tensor,
    umi_rows: torch.Tensor,
    index: torch.Tensor,
    salt: int | None = None,
) -> torch.Tensor:
    """Fused record assembly: ASCII rows ``(N, bc_len)`` and ``(N, umi_len)``
    uint8 plus the ``(N,)`` int64 index (u64 bits) → ``(N, 3)`` int64 records
    ``[barcode, umi, index]``. Total: any byte encodes (validate on the host
    first); lowercase encodes like uppercase.

    ``salt`` (a u32, default none) is XORed into both 32-bit halves of the
    index inside the kernel, as in the JAX package's kernel."""
    salt = _check_salt(salt)
    _check_tensor(bc_rows, "bc_rows", torch.uint8, 2)
    _check_tensor(umi_rows, "umi_rows", torch.uint8, 2)
    _check_tensor(index, "index", torch.int64, 1)
    n, bc_len = bc_rows.shape
    umi_len = umi_rows.shape[1]
    _check_len(bc_len, "barcode length")
    _check_len(umi_len, "UMI length")
    if umi_rows.shape[0] != n or index.shape[0] != n:
        raise ValueError(
            f"record counts differ: {n} barcodes, {umi_rows.shape[0]} UMIs, "
            f"{index.shape[0]} indices"
        )
    device = bc_rows.device
    _check_device(device, umi_rows, index)
    if device.type == "cpu":
        return plain_encode_records(bc_rows, umi_rows, index, salt)
    out = torch.empty((n, 3), dtype=torch.int64, device=device)
    if n == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(device):
        rc = lib.ibu_encode_records(
            bc_rows.data_ptr(), umi_rows.data_ptr(), index.data_ptr(),
            out.data_ptr(), n, bc_len, umi_len, salt,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on(rc, "encode_records")
    encode_records.launches += 1
    return out


encode_records.launches = 0


def decode_records(
    records: torch.Tensor, bc_len: int, umi_len: int, salt: int | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused record disassembly: ``(N, 3)`` int64 records → uppercase ASCII
    rows ``(N, bc_len)`` and ``(N, umi_len)`` uint8 and the ``(N,)`` int64
    index, XORed with ``salt`` as in :func:`encode_records`; the inverse of
    :func:`encode_records`."""
    salt = _check_salt(salt)
    _check_len(bc_len, "barcode length")
    _check_len(umi_len, "UMI length")
    _check_tensor(records, "records", torch.int64, 2)
    if records.shape[1] != 3:
        raise ValueError(f"records must be (N, 3), got {tuple(records.shape)}")
    device = records.device
    _check_device(device)
    if device.type == "cpu":
        return plain_decode_records(records, bc_len, umi_len, salt)
    n = records.shape[0]
    bc = torch.empty((n, bc_len), dtype=torch.uint8, device=device)
    umi = torch.empty((n, umi_len), dtype=torch.uint8, device=device)
    index = torch.empty((n,), dtype=torch.int64, device=device)
    if n == 0:
        return bc, umi, index
    lib = _build.load()
    with torch.cuda.device(device):
        rc = lib.ibu_decode_records(
            records.data_ptr(), bc.data_ptr(), umi.data_ptr(), index.data_ptr(),
            n, bc_len, umi_len, salt, torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on(rc, "decode_records")
    decode_records.launches += 1
    return bc, umi, index


decode_records.launches = 0


#: Plain torch version of :func:`encode_planes`.
plain_encode_planes = torch_pack
#: Plain torch version of :func:`decode_planes`.
plain_decode_planes = torch_unpack


def encode_planes(rows: torch.Tensor) -> torch.Tensor:
    """Single-field encode: ASCII rows ``(N, L)`` uint8, L in 1..32 →
    ``(N,)`` int64 packed words (u64 bits). Total, and case-insensitive,
    like :func:`encode_records`."""
    _check_tensor(rows, "rows", torch.uint8, 2)
    n, length = rows.shape
    _check_len(length, "base count")
    device = rows.device
    _check_device(device)
    if device.type == "cpu":
        return plain_encode_planes(rows)
    out = torch.empty((n,), dtype=torch.int64, device=device)
    if n == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(device):
        rc = lib.ibu_encode_planes(
            rows.data_ptr(), out.data_ptr(), n, length,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on(rc, "encode_planes")
    encode_planes.launches += 1
    return out


encode_planes.launches = 0


def decode_planes(words: torch.Tensor, length: int) -> torch.Tensor:
    """Single-field decode: ``(N,)`` int64 words → ``(N, length)`` uppercase
    ASCII uint8; bits above ``2 * length`` are ignored."""
    _check_len(length, "base count")
    _check_tensor(words, "words", torch.int64, 1)
    device = words.device
    _check_device(device)
    if device.type == "cpu":
        return plain_decode_planes(words, length)
    n = words.shape[0]
    rows = torch.empty((n, length), dtype=torch.uint8, device=device)
    if n == 0:
        return rows
    lib = _build.load()
    with torch.cuda.device(device):
        rc = lib.ibu_decode_planes(
            words.data_ptr(), rows.data_ptr(), n, length,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on(rc, "decode_planes")
    decode_planes.launches += 1
    return rows


decode_planes.launches = 0
