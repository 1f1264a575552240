"""Host runtime: the threaded field-sum engine, the host 2-bit codec, the
FASTQ chunk parser, the record sort, the external merge sort and the merges of
sorted runs and files.

The port's copy of the parts of :mod:`ibu_tpu.native` it uses:
:func:`checksum_parallel`, :func:`pack_2bit`, :func:`unpack_2bit`,
:func:`fastq_gather`, :func:`sort_records`, :func:`sort_file`,
:func:`run_interval`, :func:`merge_runs_interval` and :func:`merge_files`, on
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

from ibu_tpu_torch.constructs.header import HEADER_SIZE, Header
from ibu_tpu_torch.constructs.record import RECORD_DTYPE
from ibu_tpu_torch.errors import InvalidMapSize
from ibu_tpu_torch.ops._build import BUILD_DIR, CSRC

SOURCE = CSRC / "host_native.cpp"
CXX_FLAGS = ("-O3", "-funroll-loops", "-std=c++17", "-shared", "-fPIC", "-pthread")
_EINVAL = 22
U64_MAX = (1 << 64) - 1

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
    paths = ctypes.POINTER(ctypes.c_char_p)
    lib.ibu_fastq_gather.argtypes = [ptr, u64, u64, u32, u64, ptr, u64, ptr]
    lib.ibu_fastq_gather.restype = i32
    lib.ibu_sort_records.argtypes = [ptr, u64]
    lib.ibu_sort_records.restype = i32
    lib.ibu_sort_file.argtypes = [ctypes.c_char_p, ctypes.c_char_p, u64, i32]
    lib.ibu_sort_file.restype = i32
    lib.ibu_run_interval.argtypes = [ctypes.c_char_p, ptr, ptr, i32, ptr]
    lib.ibu_run_interval.restype = i32
    lib.ibu_merge_runs_interval_mt.argtypes = [paths, u64, ptr, ptr, i32, ctypes.c_char_p, u64,
                                               i32, u64]
    lib.ibu_merge_runs_interval_mt.restype = i32
    lib.ibu_merge_files.argtypes = [paths, u64, ctypes.c_char_p]
    lib.ibu_merge_files.restype = i32
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


def sort_file(in_path: str, out_path: str, chunk_records: int = 0, nthreads: int = 0) -> None:
    """Out-of-core external merge sort of a whole IBU file.

    Sorts ``in_path`` (which may exceed RAM) into ``out_path`` with the
    header's sorted flag set: chunked parallel in-memory sorts spill
    headerless runs beside the output, then a key-range-parallel k-way merge
    writes the result. ``chunk_records=0`` → 32 MB chunks; ``nthreads=0`` →
    all cores. A ragged record region raises :class:`InvalidMapSize`.
    """
    rc = _require().ibu_sort_file(os.fsencode(in_path), os.fsencode(out_path), chunk_records,
                                  nthreads)
    if rc == -_EINVAL:
        raise InvalidMapSize()
    _check(rc, "sort_file")


def sort_records(records: np.ndarray) -> np.ndarray:
    """Lexicographic sort of a structured record array; returns the sorted
    array.

    Sorts in place when the input is contiguous and writeable; otherwise
    (read-only memmaps, strided views) a contiguous copy is sorted and
    returned. The caller must use the return value either way.
    """
    lib = _require()
    if records.dtype != RECORD_DTYPE:
        raise ValueError(f"expected dtype {RECORD_DTYPE}")
    if not (records.flags.c_contiguous and records.flags.writeable):
        records = np.array(records)  # writable contiguous copy
    _check(lib.ibu_sort_records(records.ctypes.data, len(records)), "sort_records")
    return records


def fastq_gather(
    data, first_lineno: int, prefix_len: int, start_cap: int | None = None
) -> tuple[np.ndarray, int, int, bool, int, int]:
    """Prefix rows of the sequence lines among ``data``'s complete lines.

    The native FASTQ chunk parser (memchr scan and one memcpy per read):
    returns ``(rows, consumed, lines, capped, err_line, err_content)`` where
    ``rows`` is an ``(N, prefix_len)`` uint8 array, ``consumed`` the byte
    offset after the last processed line, ``lines`` the number of processed
    lines, and ``capped`` whether a line at or after ``start_cap`` stopped
    processing (the byte-range cut). A sequence line shorter than
    ``prefix_len`` returns with ``err_line >= 0`` instead of raising: the
    caller owns the user-facing message.
    """
    lib = _require()
    arr = np.frombuffer(data, dtype=np.uint8)
    # sequence-line bound: a sequence line costs prefix_len+1 bytes and its 3
    # sibling lines at least 1 byte each (the newline: name, plus and quality
    # lines may all be empty), so S sequence lines need at least
    # S*(prefix_len+4) - 3 bytes. A bound that assumes non-empty siblings
    # fails with ENOMEM on FASTQs with empty quality lines.
    max_rows = (len(arr) + 3) // (prefix_len + 4) + 2
    rows = np.empty((max_rows, prefix_len), dtype=np.uint8)
    out = np.zeros(6, dtype=np.uint64)
    rc = lib.ibu_fastq_gather(arr.ctypes.data, len(arr), first_lineno, prefix_len,
                              (1 << 63) if start_cap is None else start_cap,
                              rows.ctypes.data, max_rows, out.ctypes.data)
    if rc == -_EINVAL:  # short sequence line: the caller formats the error
        return (rows[: int(out[0])], int(out[1]), int(out[2]), bool(out[3]),
                int(out[4]), int(out[5]))
    _check(rc, "fastq_gather")
    return rows[: int(out[0])], int(out[1]), int(out[2]), bool(out[3]), -1, 0


def _triple_arg(key) -> np.ndarray:
    arr = np.asarray(list(key), dtype=np.uint64)
    if arr.shape != (3,):
        raise ValueError(f"key must be a (barcode, umi, index) triple: {key}")
    return arr


def _path_array(paths: list[str]):
    return (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])


def run_interval(run_path: str, lo, hi=None) -> tuple[int, int]:
    """``[start, end)`` record indices of keys in ``[lo, hi)`` within a
    sorted headerless run (``hi=None`` → unbounded above), by binary search
    on a map of the run."""
    lo_a = _triple_arg(lo)
    hi_a = _triple_arg(hi) if hi is not None else np.zeros(3, np.uint64)
    out = np.zeros(2, dtype=np.uint64)
    _check(_require().ibu_run_interval(os.fsencode(run_path), lo_a.ctypes.data, hi_a.ctypes.data,
                                       1 if hi is None else 0, out.ctypes.data), "run_interval")
    return int(out[0]), int(out[1])


def merge_runs_interval(
    run_paths: list[str], lo, hi, out_path: str, out_byte_offset: int,
    nthreads: int = 0, expect_records: int | None = None,
) -> None:
    """k-way merge of the ``[lo, hi)`` key interval of every sorted
    headerless run, pwritten into the EXISTING ``out_path`` at
    ``out_byte_offset`` (``hi=None`` → unbounded above).

    The merge is key-range-parallel across ``nthreads`` (0 → all cores;
    sampled sub-splitters, byte-identical output for any splitter choice).
    Run order is verified while merging (``EILSEQ`` on violation, like
    :func:`merge_files`); ``expect_records`` cross-checks the interval's
    total, so a wrong partition aborts instead of leaving zeros in the
    pre-truncated output.
    """
    lib = _require()
    if not run_paths:
        return
    lo_a = _triple_arg(lo)
    hi_a = _triple_arg(hi) if hi is not None else np.zeros(3, np.uint64)
    _check(
        lib.ibu_merge_runs_interval_mt(
            _path_array(run_paths), len(run_paths), lo_a.ctypes.data, hi_a.ctypes.data,
            1 if hi is None else 0, os.fsencode(out_path), out_byte_offset, nthreads,
            U64_MAX if expect_records is None else expect_records,
        ),
        "merge_runs_interval",
    )


def merge_files(in_paths: list[str], out_path: str) -> None:
    """k-way merge of ALREADY-SORTED IBU files into one sorted file.

    Inputs are merged by a priority queue in one pass with bounded memory.
    Headers must agree on (bc_len, umi_len) and carry the sorted flag; an
    input whose records are not actually in order aborts with ``EILSEQ``
    ("Invalid or incomplete multibyte or wide character" per strerror)
    rather than emitting a mis-sorted file.
    """
    lib = _require()
    if not in_paths:
        raise ValueError("merge_files needs at least one input")
    # out_path aliasing an input would truncate that input mid-merge and
    # then unlink it on the resulting failure: refuse up front
    for p in in_paths:
        if os.path.exists(p) and os.path.exists(out_path):
            same = os.path.samefile(p, out_path)
        else:
            same = os.path.realpath(p) == os.path.realpath(out_path)
        if same:
            raise ValueError(
                f"output {out_path!r} is the same file as input {p!r}; "
                "merge to a different path"
            )
    first = None
    for p in in_paths:
        with open(p, "rb") as f:
            h = Header.from_bytes(f.read(HEADER_SIZE))
        h.validate()
        if not h.sorted():
            raise ValueError(f"{p}: sorted flag not set; sort it first")
        if first is None:
            first = (h.bc_len, h.umi_len)
        elif (h.bc_len, h.umi_len) != first:
            raise ValueError(
                f"{p}: header (bc_len={h.bc_len}, umi_len={h.umi_len}) "
                f"differs from {in_paths[0]} {first}"
            )
    _check(lib.ibu_merge_files(_path_array(in_paths), len(in_paths), os.fsencode(out_path)),
           "merge_files")
