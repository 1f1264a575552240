"""Host runtime: the threaded field-sum engine and the host 2-bit codec.

The port's copy of the parts of :mod:`ibu_tpu.native` it uses:
:func:`checksum_parallel`, :func:`pack_2bit` and :func:`unpack_2bit`, on
``csrc/host_native.cpp``. ``g++`` builds the source at first use into
``build/ibu_tpu_torch/libibu_host_<hash>.so`` beside the package, named by a
hash of the source and the flags, through a private temporary file renamed
into place, so concurrent first uses (test workers) never see a half-written
library. It is a host library: it needs no CUDA toolkit.

Where it cannot be built, :func:`available` is false, :func:`load_error`
says why, and callers take their numpy paths, as the JAX package's do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import uuid
from pathlib import Path

import numpy as np

from ibu_tpu_torch.ops._build import BUILD_DIR, CSRC

SOURCE = CSRC / "host_native.cpp"
CXX_FLAGS = ("-O3", "-funroll-loops", "-std=c++17", "-shared", "-fPIC", "-pthread")
_EINVAL = 22

_lib: ctypes.CDLL | None = None
_load_error: str | None = None


class NativeBuildError(RuntimeError):
    pass


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0" + SOURCE.read_bytes())
    return BUILD_DIR / f"libibu_host_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the source with ``g++`` unless a library for it exists."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f".{lib.name}.{os.getpid()}.{uuid.uuid4().hex}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise NativeBuildError(f"g++ failed ({proc.returncode}): {proc.stderr[-4000:]}")
        os.replace(tmp, lib)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeBuildError(f"failed to run g++: {e}") from e
    finally:
        tmp.unlink(missing_ok=True)
    return lib


def _load() -> ctypes.CDLL | None:
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    try:
        lib = ctypes.CDLL(str(build()))
    except (NativeBuildError, OSError) as e:
        _load_error = str(e)
        return None
    ptr, u64, u32, i32 = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_int
    lib.ibu_checksum_parallel.argtypes = [ctypes.c_char_p, u64, ptr, i32]
    lib.ibu_checksum_parallel.restype = i32
    lib.ibu_pack_2bit_mt.argtypes = [ptr, u64, u32, ptr, i32, i32]
    lib.ibu_pack_2bit_mt.restype = i32
    lib.ibu_unpack_2bit_mt.argtypes = [ptr, u64, u32, ptr, i32]
    lib.ibu_unpack_2bit_mt.restype = i32
    _lib = lib
    return lib


def available() -> bool:
    """Whether the host library could be built and loaded."""
    return _load() is not None


def load_error() -> str | None:
    """Why the library is unavailable, or ``None``."""
    _load()
    return _load_error


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native runtime unavailable: {_load_error}")
    return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise OSError(-rc, f"native {what} failed: {os.strerror(-rc)}")


def checksum_parallel(path: str, n_records: int, nthreads: int = 0) -> tuple[int, int, int]:
    """Wrapping u64 sums of the barcode, UMI and index fields of the first
    ``n_records`` records of the IBU file at ``path``, over ``nthreads``
    threads (0: all cores), through an mmap of the file."""
    out = np.zeros(3, dtype=np.uint64)
    _check(_require().ibu_checksum_parallel(os.fsencode(path), n_records, out.ctypes.data,
                                            nthreads), "checksum_parallel")
    return int(out[0]), int(out[1]), int(out[2])


def pack_2bit(ascii_rows: np.ndarray, validate: bool = True, nthreads: int = 0) -> np.ndarray:
    """``(N, L)`` ASCII rows → ``(N,)`` uint64 words, L in 1..32; split over
    ``nthreads`` threads (0: all cores) from 65,536 rows. With ``validate``, a base other
    than ACGT (either case) raises ``ValueError``."""
    ascii_rows = np.ascontiguousarray(ascii_rows, dtype=np.uint8)
    n, length = ascii_rows.shape
    out = np.empty(n, dtype=np.uint64)
    rc = _require().ibu_pack_2bit_mt(ascii_rows.ctypes.data, n, length, out.ctypes.data,
                                     1 if validate else 0, nthreads)
    if rc == -_EINVAL:
        raise ValueError("invalid nucleotide or length in pack_2bit")
    _check(rc, "pack_2bit")
    return out


def unpack_2bit(words: np.ndarray, length: int, nthreads: int = 0) -> np.ndarray:
    """``(N,)`` uint64 words → ``(N, length)`` uppercase ASCII rows; split
    over ``nthreads`` threads (0: all cores) from 65,536 rows."""
    words = np.ascontiguousarray(words, dtype=np.uint64)
    out = np.empty((len(words), length), dtype=np.uint8)
    _check(_require().ibu_unpack_2bit_mt(words.ctypes.data, len(words), length,
                                         out.ctypes.data, nthreads), "unpack_2bit")
    return out
