"""The codec labs' CUDA kernels: wrappers and their plain torch versions.

The kernels live in ``ibu_tpu_torch/csrc/codec_lab.cu`` (built with the
production codec by :mod:`ibu_tpu_torch.ops._build`); its source note says
what each mode, layout and record width does. Six wrappers launch them:

- :func:`sol_encode` / :func:`sol_decode`: the speed-of-light modes on the
  production layout, ``(N, 16)`` + ``(N, 12)`` uint8 rows and ``(N, 3)``
  int64 records (``tools/sol_lab.py::make_plane``);
- :func:`packed_encode` / :func:`packed_decode`: the same bytes as
  ``(N, 4)`` + ``(N, 3)`` int32 words (``tools/sol_lab.py::make_packed``);
- :func:`layout_encode` / :func:`layout_decode`: the production codec under
  the layout axes of ``tools/kernel_lab.py::make_roundtrip``: separate or
  combined ``(N, 32)`` rows, ``(N, 3)`` or ``(N, 4)`` records.

As in :mod:`ibu_tpu_torch.ops.codec_cuda`, a wrapper given CUDA tensors
launches its kernel on the current stream and raises if the launch fails;
given CPU tensors it runs the plain version beside it, with no fallback from
one to the other. Each wrapper counts its launches in ``launches``.

The floor modes are defined here, not by the TPU lab (whose touch kernels
read one row of a block the grid pipeline moved whole): ``touch`` encode
writes ``[bc[0:8] ^ bc[8:16], umi[0:8] ^ umi[8:12], index]`` (bytes as
little-endian words), ``touch`` decode writes the barcode row as the bytes
of the first two record words and the UMI row as its first 12 bytes;
``reduce`` encode writes the largest byte of each row, ``reduce`` decode the
largest byte of the first two record words into every base. Each copies the
index.
"""

from __future__ import annotations

import torch

from ibu_tpu_torch.ops import _build
from ibu_tpu_torch.ops.codec_cuda import (
    _check_device,
    _check_tensor,
    _raise_on,
    _stream,
    torch_pack,
    torch_unpack,
)

BC, UMI, COMB = 16, 12, 32
#: encode modes, in the order of the C interface's mode numbers
ENC_MODES = ("real", "tree", "swar", "dp4a", "touch", "reduce")
#: decode modes, likewise
DEC_MODES = ("nib", "lut", "touch", "reduce")
#: the modes that compute the codec; the others are floors
CODEC_ENC = ("real", "tree", "swar", "dp4a")
CODEC_DEC = ("nib", "lut")
_SEP, _COMB, _PACKED = 0, 1, 2
_PAD_A = 65


def _check_mode(mode: str, modes: tuple[str, ...], what: str) -> int:
    if mode not in modes:
        raise ValueError(f"unknown {what} mode {mode!r}; expected one of {', '.join(modes)}")
    return modes.index(mode)


def _check_block(block: int) -> None:
    if not (32 <= block <= 1024 and block % 32 == 0):
        raise ValueError(f"block {block} is not a multiple of 32 in 32..=1024")


def _check_rows(t: torch.Tensor, name: str, dtype: torch.dtype, width: int, n: int | None) -> None:
    _check_tensor(t, name, dtype, 2)
    if t.shape[1] != width:
        raise ValueError(f"{name} must be (N, {width}), got {tuple(t.shape)}")
    if n is not None and t.shape[0] != n:
        raise ValueError(f"{name} holds {t.shape[0]} records, expected {n}")


def _check_records(records: torch.Tensor, widths: tuple[int, ...]) -> None:
    _check_tensor(records, "records", torch.int64, 2)
    if records.shape[1] not in widths:
        shapes = " or ".join(f"(N, {w})" for w in widths)
        raise ValueError(f"records must be {shapes}, got {tuple(records.shape)}")


def _encode(kernel, a, b, index, n, mode, layout, cols, block):
    device = index.device
    out = torch.empty((n, cols), dtype=torch.int64, device=device)
    if n == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(device):
        rc = lib.ibu_lab_encode(
            a.data_ptr(), 0 if b is None else b.data_ptr(), index.data_ptr(), out.data_ptr(),
            n, mode, layout, cols, block, _stream(device),
        )
    _raise_on(rc, kernel.__name__)
    kernel.launches += 1
    return out


def _decode(kernel, records, a, b, mode, layout, block):
    device = records.device
    n, cols = records.shape
    index = torch.empty((n,), dtype=torch.int64, device=device)
    if n == 0:
        return index
    lib = _build.load()
    with torch.cuda.device(device):
        rc = lib.ibu_lab_decode(
            records.data_ptr(), a.data_ptr(), 0 if b is None else b.data_ptr(), index.data_ptr(),
            n, mode, layout, cols, block, _stream(device),
        )
    _raise_on(rc, kernel.__name__)
    kernel.launches += 1
    return index


# ---------------------------------------------------------------------------
# plain torch versions
# ---------------------------------------------------------------------------


def _as(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The bytes of ``t``'s rows as ``dtype``, little-endian, read from a
    fresh copy so that a view at any byte offset will do."""
    return t.clone(memory_format=torch.contiguous_format).view(dtype)


def plain_sol_encode(bc: torch.Tensor, umi: torch.Tensor, index: torch.Tensor,
                     mode: str = "real") -> torch.Tensor:
    """Plain torch version of :func:`sol_encode`."""
    _check_mode(mode, ENC_MODES, "encode")
    if mode in CODEC_ENC:
        b, u = torch_pack(bc), torch_pack(umi)
    elif mode == "touch":
        bw = _as(bc, torch.int64)
        uw = torch.cat([umi, torch.zeros_like(umi[:, :4])], dim=1).view(torch.int64)
        b, u = bw[:, 0] ^ bw[:, 1], uw[:, 0] ^ uw[:, 1]
    else:  # reduce
        b, u = bc.amax(dim=1).to(torch.int64), umi.amax(dim=1).to(torch.int64)
    return torch.stack([b, u, index], dim=1)


def plain_sol_decode(records: torch.Tensor, mode: str = "nib"
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`sol_decode`."""
    _check_mode(mode, DEC_MODES, "decode")
    if mode in CODEC_DEC:
        bc, umi = torch_unpack(records[:, 0], BC), torch_unpack(records[:, 1], UMI)
    elif mode == "touch":
        bc = _as(records[:, :2], torch.uint8)
        umi = bc[:, :UMI].contiguous()
    else:  # reduce
        top = _as(records[:, :2], torch.uint8).amax(dim=1, keepdim=True)
        bc, umi = top.expand(-1, BC).contiguous(), top.expand(-1, UMI).contiguous()
    return bc, umi, records[:, 2].contiguous()


def plain_packed_encode(bcp: torch.Tensor, umip: torch.Tensor, index: torch.Tensor,
                        sol: bool = False) -> torch.Tensor:
    """Plain torch version of :func:`packed_encode`."""
    return plain_sol_encode(_as(bcp, torch.uint8), _as(umip, torch.uint8), index,
                            "touch" if sol else "real")


def plain_packed_decode(records: torch.Tensor, sol: bool = False
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`packed_decode`."""
    bc, umi, index = plain_sol_decode(records, "touch" if sol else "nib")
    return _as(bc, torch.int32), _as(umi, torch.int32), index


def _split_rows(rows: tuple[torch.Tensor, ...]) -> tuple[torch.Tensor, torch.Tensor]:
    if len(rows) == 1:
        return rows[0][:, :BC], rows[0][:, BC:BC + UMI]
    return rows


def plain_layout_encode(rows: tuple[torch.Tensor, ...], index: torch.Tensor,
                        records: int = 3) -> torch.Tensor:
    """Plain torch version of :func:`layout_encode`."""
    bc, umi = _split_rows(rows)
    cols = [torch_pack(bc), torch_pack(umi), index]
    if records == 4:
        cols.append(torch.zeros_like(index))
    return torch.stack(cols, dim=1)


def plain_layout_decode(records: torch.Tensor, comb: bool = False) -> tuple[torch.Tensor, ...]:
    """Plain torch version of :func:`layout_decode`."""
    bc, umi = torch_unpack(records[:, 0], BC), torch_unpack(records[:, 1], UMI)
    index = records[:, 2].contiguous()
    if not comb:
        return bc, umi, index
    pad = torch.full((records.shape[0], COMB - BC - UMI), _PAD_A, dtype=torch.uint8,
                     device=records.device)
    return torch.cat([bc, umi, pad], dim=1), index


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def sol_encode(bc: torch.Tensor, umi: torch.Tensor, index: torch.Tensor,
               mode: str = "real", block: int = 256) -> torch.Tensor:
    """``(N, 16)`` and ``(N, 12)`` uint8 rows and the ``(N,)`` int64 index →
    ``(N, 3)`` int64 records, by encode ``mode`` (:data:`ENC_MODES`; ``real``
    is the production ``pack_row``, ``tree``, ``swar`` and ``dp4a`` compute
    the same words another way, ``touch`` and ``reduce`` are the floors)."""
    code = _check_mode(mode, ENC_MODES, "encode")
    _check_block(block)
    _check_tensor(index, "index", torch.int64, 1)
    n = index.shape[0]
    _check_rows(bc, "bc", torch.uint8, BC, n)
    _check_rows(umi, "umi", torch.uint8, UMI, n)
    _check_device(index.device, bc, umi)
    if index.device.type == "cpu":
        return plain_sol_encode(bc, umi, index, mode)
    return _encode(sol_encode, bc, umi, index, n, code, _SEP, 3, block)


sol_encode.launches = 0


def sol_decode(records: torch.Tensor, mode: str = "nib", block: int = 256
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(N, 3)`` int64 records → ``(N, 16)`` and ``(N, 12)`` uint8 rows and
    the ``(N,)`` int64 index, by decode ``mode`` (:data:`DEC_MODES`; ``nib``
    is the production ``unpack_row``, ``lut`` the arithmetic map, ``touch``
    and ``reduce`` the floors)."""
    code = _check_mode(mode, DEC_MODES, "decode")
    _check_block(block)
    _check_records(records, (3,))
    _check_device(records.device)
    if records.device.type == "cpu":
        return plain_sol_decode(records, mode)
    n = records.shape[0]
    bc = torch.empty((n, BC), dtype=torch.uint8, device=records.device)
    umi = torch.empty((n, UMI), dtype=torch.uint8, device=records.device)
    index = _decode(sol_decode, records, bc, umi, code, _SEP, block)
    return bc, umi, index


sol_decode.launches = 0


def packed_encode(bcp: torch.Tensor, umip: torch.Tensor, index: torch.Tensor,
                  sol: bool = False, block: int = 256) -> torch.Tensor:
    """ASCII as ``(N, 4)`` and ``(N, 3)`` int32 words (4 bases per word,
    base 4g + j in byte j of word g) → ``(N, 3)`` int64 records: the
    production codec, or with ``sol`` the ``touch`` floor."""
    _check_block(block)
    _check_tensor(index, "index", torch.int64, 1)
    n = index.shape[0]
    _check_rows(bcp, "bcp", torch.int32, BC // 4, n)
    _check_rows(umip, "umip", torch.int32, UMI // 4, n)
    _check_device(index.device, bcp, umip)
    if index.device.type == "cpu":
        return plain_packed_encode(bcp, umip, index, sol)
    mode = ENC_MODES.index("touch" if sol else "real")
    return _encode(packed_encode, bcp, umip, index, n, mode, _PACKED, 3, block)


packed_encode.launches = 0


def packed_decode(records: torch.Tensor, sol: bool = False, block: int = 256
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(N, 3)`` int64 records → ``(N, 4)`` and ``(N, 3)`` int32 ASCII words
    and the index: the production decode, or with ``sol`` the ``touch``
    floor."""
    _check_block(block)
    _check_records(records, (3,))
    _check_device(records.device)
    if records.device.type == "cpu":
        return plain_packed_decode(records, sol)
    n = records.shape[0]
    bcp = torch.empty((n, BC // 4), dtype=torch.int32, device=records.device)
    umip = torch.empty((n, UMI // 4), dtype=torch.int32, device=records.device)
    mode = DEC_MODES.index("touch" if sol else "nib")
    index = _decode(packed_decode, records, bcp, umip, mode, _PACKED, block)
    return bcp, umip, index


packed_decode.launches = 0


def layout_encode(rows: tuple[torch.Tensor, ...], index: torch.Tensor,
                  records: int = 3, block: int = 256) -> torch.Tensor:
    """The production encode under a layout: ``rows`` is ``(bc, umi)``,
    ``(N, 16)`` and ``(N, 12)`` uint8 (enc-in ``sep``), or ``(comb,)``, one
    ``(N, 32)`` uint8 row whose bases 28-31 are ignored (``comb``). Gives
    ``(N, records)`` int64 records, ``records`` 3 or 4 (a zero fourth
    word)."""
    _check_block(block)
    if records not in (3, 4):
        raise ValueError(f"records must be 3 or 4 words, got {records}")
    _check_tensor(index, "index", torch.int64, 1)
    n = index.shape[0]
    if len(rows) == 1:
        _check_rows(rows[0], "comb", torch.uint8, COMB, n)
        layout, a, b = _COMB, rows[0], None
    elif len(rows) == 2:
        _check_rows(rows[0], "bc", torch.uint8, BC, n)
        _check_rows(rows[1], "umi", torch.uint8, UMI, n)
        layout, (a, b) = _SEP, rows
    else:
        raise ValueError(f"rows must be (bc, umi) or (comb,), got {len(rows)} tensors")
    _check_device(index.device, *rows)
    if index.device.type == "cpu":
        return plain_layout_encode(rows, index, records)
    return _encode(layout_encode, a, b, index, n, 0, layout, records, block)


layout_encode.launches = 0


def layout_decode(records: torch.Tensor, comb: bool = False, block: int = 256
                  ) -> tuple[torch.Tensor, ...]:
    """The production decode of ``(N, 3)`` or ``(N, 4)`` int64 records into
    ``(bc, umi, index)`` rows (dec-out ``sep``) or, with ``comb``, into one
    ``(N, 32)`` uint8 row with bases 28-31 'A', and the index."""
    _check_block(block)
    _check_records(records, (3, 4))
    _check_device(records.device)
    if records.device.type == "cpu":
        return plain_layout_decode(records, comb)
    n = records.shape[0]
    device = records.device
    if comb:
        rows = torch.empty((n, COMB), dtype=torch.uint8, device=device)
        return rows, _decode(layout_decode, records, rows, None, 0, _COMB, block)
    bc = torch.empty((n, BC), dtype=torch.uint8, device=device)
    umi = torch.empty((n, UMI), dtype=torch.uint8, device=device)
    return bc, umi, _decode(layout_decode, records, bc, umi, 0, _SEP, block)


layout_decode.launches = 0

#: every lab wrapper, with its plain version and the TPU kernel it replaces
KERNELS = {
    "sol_encode": (sol_encode, plain_sol_encode, "tools/sol_lab.py:81"),
    "sol_decode": (sol_decode, plain_sol_decode, "tools/sol_lab.py:81"),
    "packed_encode": (packed_encode, plain_packed_encode, "tools/sol_lab.py:81"),
    "packed_decode": (packed_decode, plain_packed_decode, "tools/sol_lab.py:81"),
    "layout_encode": (layout_encode, plain_layout_encode, "tools/kernel_lab.py:99"),
    "layout_decode": (layout_decode, plain_layout_decode, "tools/kernel_lab.py:118"),
}
