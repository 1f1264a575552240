"""Build and load the CUDA library (``csrc/codec.cu``, ``csrc/codec_lab.cu``,
``csrc/record_sort.cu`` and ``csrc/sort_lab.cu``).

``nvcc`` compiles the sources of this checkout into a shared library with a
plain C interface, which :func:`load` opens with ``ctypes``: one ``nvcc`` per
``.cu`` file, all started together, then one link. The library is built at
first use into ``build/ibu_tpu_torch/`` beside the package, named by a hash of
every ``.cu`` and ``.cuh`` file under ``csrc/`` and the flags, so an edited
source or header rebuilds and an unchanged tree loads at once. Each build
writes private temporary files and renames the library into place, so
concurrent first uses never see a half-written library. ``nvcc``'s report
(``-Xptxas -v``: registers, shared memory and spills of each kernel) is kept
beside the library as ``<name>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import uuid
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
SOURCES = tuple(sorted(CSRC.glob("*.cu")))
BUILD_DIR = _PKG.parent / "build" / "ibu_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib: ctypes.CDLL | None = None


class CudaBuildError(RuntimeError):
    pass


def find_nvcc() -> str:
    """``nvcc`` on ``PATH``, else under ``$CUDA_HOME/bin`` (default
    ``/usr/local/cuda``); raises :class:`CudaBuildError` when neither has it."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise CudaBuildError(
        f"nvcc not found on PATH or at {candidate}; the CUDA codec kernels "
        "need the CUDA toolkit (set CUDA_HOME to its root)"
    )


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"libibu_codec_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for them already exists."""
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = f".{lib.name}.{os.getpid()}.{uuid.uuid4().hex}"
    tmp = lib.with_name(stem + ".tmp")
    objs = [lib.with_name(f"{stem}.{src.stem}.o") for src in SOURCES]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(SOURCES, objs)]
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    try:
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for cmd in compiles]
        # wait for every compile before reporting a failure, so none outlives the build
        report = [proc.communicate()[1] for proc in procs]
        for cmd, proc, err in zip(compiles, procs, report):
            _check(proc.returncode, cmd, err)
        proc = subprocess.run(link, capture_output=True, text=True)
        _check(proc.returncode, link, proc.stderr)
        lib.with_suffix(".log").write_text("".join(report) + proc.stderr)
        os.replace(tmp, lib)
    finally:
        for path in (tmp, *objs):
            path.unlink(missing_ok=True)
    return lib


def _check(returncode: int, cmd: list[str], stderr: str) -> None:
    if returncode != 0:
        raise CudaBuildError(
            f"nvcc failed ({returncode}): {' '.join(cmd)}\n{stderr[-4000:]}"
        )


def load() -> ctypes.CDLL:
    """Build if needed, then open the library and declare its C interface."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    ptr, i64, i32, u32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_uint32
    u64 = ctypes.c_uint64
    lib.ibu_encode_records.argtypes = [ptr, ptr, ptr, ptr, i64, i32, i32, u32, ptr]
    lib.ibu_encode_records.restype = i32
    lib.ibu_decode_records.argtypes = [ptr, ptr, ptr, ptr, i64, i32, i32, u32, ptr]
    lib.ibu_decode_records.restype = i32
    lib.ibu_encode_planes.argtypes = [ptr, ptr, i64, i32, ptr]
    lib.ibu_encode_planes.restype = i32
    lib.ibu_decode_planes.argtypes = [ptr, ptr, i64, i32, ptr]
    lib.ibu_decode_planes.restype = i32
    # a, b, index, out | records, a, b, index; n, mode, layout, cols, block, stream
    lib.ibu_lab_encode.argtypes = [ptr, ptr, ptr, ptr, i64, i32, i32, i32, i32, ptr]
    lib.ibu_lab_encode.restype = i32
    lib.ibu_lab_decode.argtypes = [ptr, ptr, ptr, ptr, i64, i32, i32, i32, i32, ptr]
    lib.ibu_lab_decode.restype = i32
    # keys [, offs], out, tiles, stream
    lib.ibu_lab_digit_histogram.argtypes = [ptr, ptr, i64, ptr]
    lib.ibu_lab_digit_histogram.restype = i32
    lib.ibu_lab_rank_cumsum.argtypes = [ptr, ptr, i64, ptr]
    lib.ibu_lab_rank_cumsum.restype = i32
    lib.ibu_lab_dynamic_store.argtypes = [ptr, ptr, ptr, i64, ptr]
    lib.ibu_lab_dynamic_store.restype = i32
    # records, n, ors, stream
    lib.ibu_field_ors.argtypes = [ptr, i64, ptr, ptr]
    lib.ibu_field_ors.restype = i32
    # records, n, ors, three masks, words, passes, scratch, out, stream
    lib.ibu_record_sort.argtypes = [ptr, i64, ptr, u64, u64, u64, i32, i32, ptr, ptr, ptr]
    lib.ibu_record_sort.restype = i32
    lib.ibu_record_sort_scratch_bytes.argtypes = [i64, i32]
    lib.ibu_record_sort_scratch_bytes.restype = i64
    # parts; keys, strides, weights, lengths (one each a part), key mask; words, passes,
    # scratch, out keys, out sums, slots, n_distinct, stream
    ptrs, i64s = ctypes.POINTER(ptr), ctypes.POINTER(i64)
    lib.ibu_group_sum.argtypes = [i32, ptrs, i64s, ptrs, i64s, u64, i32, i32, ptr, ptr, ptr, i64,
                                  ptr, ptr]
    lib.ibu_group_sum.restype = i32
    lib.ibu_group_sum_scratch_bytes.argtypes = [i64, i32]
    lib.ibu_group_sum_scratch_bytes.restype = i64
    lib.ibu_cuda_error_string.argtypes = [i32]
    lib.ibu_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib
