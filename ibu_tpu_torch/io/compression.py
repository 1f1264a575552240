"""Transparent gzip/zstd compression for IBU streams.

A copy of the parts of :mod:`ibu_tpu.io.compression` that the port uses.
Read side: the first bytes of a stream are sniffed for compression magic and
the stream is wrapped (the reference's niffler integration,
``src/io/reader.rs:348-357``). Write side: :func:`open_compressed` gives gzip
or zstd encoders for :meth:`ibu_tpu_torch.io.writer.Writer.from_path`, whose
files the readers sniff back. zstd needs the optional ``zstandard`` module;
without it, zstd streams raise :class:`CompressionError`.
"""

from __future__ import annotations

import collections
import gzip
import io
import zlib
from typing import BinaryIO

from ibu_tpu_torch.errors import CompressionError, IbuIoError

GZIP_MAGIC = b"\x1f\x8b"
ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"

try:  # optional, mirrors the reference's feature gate on niffler
    import zstandard as _zstd  # type: ignore

    _HAVE_ZSTD = True
except ImportError:  # pragma: no cover - depends on environment
    _zstd = None
    _HAVE_ZSTD = False

#: exception types a torn or corrupt compressed stream raises from ``read()``:
#: gzip raises ``EOFError`` (truncated member), ``zlib.error`` (corrupt
#: deflate data) or ``gzip.BadGzipFile`` (an OSError subclass, so catch this
#: tuple before any ``except OSError``), zstd ``zstandard.ZstdError``.
#: Readers map them to :class:`CompressionError`.
DECOMPRESSION_ERRORS: tuple[type[BaseException], ...] = (
    EOFError,
    zlib.error,
    gzip.BadGzipFile,
) + ((_zstd.ZstdError,) if _HAVE_ZSTD else ())


class _PeekableStream(io.RawIOBase):
    """Wraps a possibly non-seekable stream, replaying sniffed magic bytes."""

    def __init__(self, prefix: bytes, inner: BinaryIO):
        self._prefix = prefix
        self._inner = inner

    def readable(self) -> bool:
        return True

    @property
    def name(self):
        """The wrapped stream's file name, where it has one: how
        :meth:`ibu_tpu_torch.io.reader.Reader.clone` finds the disk file
        beneath the sniffing wrapper."""
        return getattr(self._inner, "name", None)

    def readinto(self, b) -> int:
        if self._prefix:
            n = min(len(b), len(self._prefix))
            b[:n] = self._prefix[:n]
            self._prefix = self._prefix[n:]
            return n
        data = self._inner.read(len(b))
        if not data:
            return 0
        b[: len(data)] = data
        return len(data)

    def close(self) -> None:
        try:
            self._inner.close()
        finally:
            super().close()


def sniff_compression(magic: bytes) -> str | None:
    """Classify a stream prefix: ``"gzip"``, ``"zstd"``, or ``None`` (plain).

    >>> sniff_compression(GZIP_MAGIC + b"\\x08\\x00")
    'gzip'
    >>> sniff_compression(ZSTD_MAGIC)
    'zstd'
    >>> sniff_compression(b"IBU!") is None
    True
    """
    if magic[:2] == GZIP_MAGIC:
        return "gzip"
    if magic[:4] == ZSTD_MAGIC:
        return "zstd"
    return None


class _ChainClosing:
    """Delegate reads and writes to a codec stream, but close the whole chain:
    ``gzip.GzipFile.close()`` (and zstd's streams, depending on version) do
    not close the file object they wrap."""

    def __init__(self, stream, *also_close):
        self._stream = stream
        self._also_close = also_close

    @property
    def name(self):
        """The file name beneath the chain, where it has one: how
        :meth:`ibu_tpu_torch.io.reader.Reader.clone` reopens a compressed
        reader."""
        for s in self._also_close:
            n = getattr(s, "name", None)
            if n is not None:
                return n
        return getattr(self._stream, "name", None)

    def read(self, n: int = -1) -> bytes:
        return self._stream.read(n)

    def write(self, data) -> int:
        # zstandard < 0.23 returns the compressed bytes flushed (0 while
        # buffering), >= 0.23 the bytes consumed; both consume all of it
        self._stream.write(data)
        return len(data)

    def flush(self) -> None:
        flush = getattr(self._stream, "flush", None)
        if flush is not None:
            flush()

    def close(self) -> None:
        try:
            self._stream.close()
        finally:
            for s in self._also_close:
                try:
                    s.close()
                except Exception:
                    pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _ZstdFrameReader:
    """zstd decoder that detects truncation.

    ``ZstdDecompressor.stream_reader`` reports a clean EOF when the stream
    tears mid-frame, so a torn archive whose tear lands on a 24-byte boundary
    would read as a shorter valid file. Decoding through ``decompressobj``
    tracks frame completion (``.eof``): input ending mid-frame raises
    ``ZstdError``. Multi-frame streams restart through ``unused_data``.
    """

    #: input slice fed per decompress call; it bounds one call's output on
    #: highly compressible data, and drops to 1 KB after a burst of output
    _SLICE = 1 << 14
    _SLICE_SMALL = 1 << 10
    _BURST_LIMIT = 4 << 20

    def __init__(self, inner: BinaryIO):
        self._inner = inner
        self._dctx = _zstd.ZstdDecompressor()
        self._obj = self._dctx.decompressobj()
        self._mid_frame = False  # bytes fed into the current frame?
        self._parts = collections.deque()
        self._avail = 0
        self._pending = b""  # compressed bytes read but not yet fed
        self._raw_eof = False
        self._slice = self._SLICE

    def _fill(self, want: int) -> None:
        while self._avail < want:
            if not self._pending:
                self._pending = self._inner.read(1 << 18) or b""
                if not self._pending:
                    if self._raw_eof:
                        return
                    self._raw_eof = True
                    if self._mid_frame and not self._obj.eof:
                        raise _zstd.ZstdError("zstd stream truncated: input ended mid-frame")
                    return
            data, self._pending = self._pending[: self._slice], self._pending[self._slice :]
            while data:
                out = self._obj.decompress(data)
                if out:
                    self._parts.append(out)
                    self._avail += len(out)
                    if len(out) > self._BURST_LIMIT:
                        self._slice = self._SLICE_SMALL
                self._mid_frame = True
                if self._obj.eof:
                    data = self._obj.unused_data
                    self._obj = self._dctx.decompressobj()
                    self._mid_frame = False
                else:
                    data = b""

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            out = []
            while True:
                self._fill(1 << 20)
                if not self._parts:
                    return b"".join(out)
                out.extend(self._parts)
                self._parts.clear()
                self._avail = 0
        self._fill(n)
        out = []
        need = n
        while need and self._parts:
            part = self._parts.popleft()
            if len(part) <= need:
                out.append(part)
                need -= len(part)
            else:
                out.append(part[:need])
                self._parts.appendleft(part[need:])
                need = 0
        got = b"".join(out)
        self._avail -= len(got)
        return got

    def close(self) -> None:
        self._inner.close()


def wrap_decompress(stream: BinaryIO) -> BinaryIO:
    """Sniff ``stream``'s magic and return a transparently decompressing
    reader; plain streams come back with the prefix replayed. Works on
    non-seekable streams. Closing the result closes the chain down to
    ``stream``."""
    prefix = stream.read(4) or b""
    kind = sniff_compression(prefix)
    replayed: BinaryIO = io.BufferedReader(_PeekableStream(prefix, stream), buffer_size=1 << 20)
    if kind is None:
        return replayed
    if kind == "gzip":
        return _ChainClosing(gzip.GzipFile(fileobj=replayed, mode="rb"), replayed)  # type: ignore[return-value]
    if not _HAVE_ZSTD:
        raise CompressionError("zstd-compressed input but the 'zstandard' module is unavailable")
    return _ChainClosing(_ZstdFrameReader(replayed), replayed)  # type: ignore[return-value]


def as_buffered(stream) -> io.BufferedReader:
    """Ensure ``stream`` supports buffered reads. Plain streams from
    :func:`open_decompressed` already are :class:`io.BufferedReader`; a bare
    ``read()``-only decompression chain goes under an empty-prefix
    :class:`_PeekableStream`. Closing the result closes the whole chain
    either way."""
    if isinstance(stream, io.BufferedReader):
        return stream
    return io.BufferedReader(_PeekableStream(b"", stream), buffer_size=1 << 20)


def open_decompressed(path: str) -> BinaryIO:
    """Open ``path`` for reading with transparent gzip/zstd decompression."""
    try:
        raw = open(path, "rb")
    except OSError as e:
        raise IbuIoError(e) from e
    return wrap_decompress(raw)


def reopen_decompressed_at(path: str, pos: int) -> BinaryIO:
    """A fresh decompression chain over ``path``, read forward to ``pos``
    decompressed bytes: how a compressed reader clones, since a compressed
    stream has no map from decompressed positions to file offsets (so the
    clone costs O(pos)). A stream that ends before ``pos`` (the file changed
    since it was opened) raises :class:`CompressionError`."""
    s = open_decompressed(path)
    try:
        skipped = 0
        while skipped < pos:
            chunk = s.read(min(1 << 20, pos - skipped))
            if not chunk:
                raise CompressionError(
                    f"{path}: stream ended at {skipped} decompressed bytes "
                    f"while cloning a reader positioned at {pos} (file "
                    "changed since the original open?)"
                )
            skipped += len(chunk)
    except BaseException:
        s.close()
        raise
    return s


#: file-extension → compression kind, used by ``compression="auto"``.
EXTENSION_KINDS = {".gz": "gzip", ".zst": "zstd", ".zstd": "zstd"}


def infer_compression(path: str) -> str | None:
    """Classify ``path`` by extension: ``"gzip"``, ``"zstd"``, or ``None``.

    >>> infer_compression("data.ibu.gz")
    'gzip'
    >>> infer_compression("data.IBU.ZST")
    'zstd'
    >>> infer_compression("data.ibu") is None
    True
    """
    lower = path.lower()
    for ext, kind in EXTENSION_KINDS.items():
        if lower.endswith(ext):
            return kind
    return None


def wrap_compress(stream: BinaryIO, kind: str, level: int | None = None,
                  threads: int = -1) -> BinaryIO:
    """Wrap ``stream`` in a gzip or zstd encoder. ``level`` is the codec's
    own (gzip 0-9, default 6; zstd 1-22, default 3); ``threads`` is the zstd
    worker count (``-1``: all cores). zstd frames carry a content checksum.
    Closing the result finalizes the frame and closes the chain."""
    if kind == "gzip":
        gz = gzip.GzipFile(fileobj=stream, mode="wb", compresslevel=6 if level is None else level)
        return _ChainClosing(gz, stream)  # type: ignore[return-value]
    if kind == "zstd":
        if not _HAVE_ZSTD:
            raise CompressionError("zstd output requested but the 'zstandard' module is unavailable")
        cctx = _zstd.ZstdCompressor(level=3 if level is None else level, write_checksum=True,
                                    threads=threads)
        return _ChainClosing(cctx.stream_writer(stream), stream)  # type: ignore[return-value]
    raise CompressionError(f"unknown compression kind {kind!r} (expected 'gzip' or 'zstd')")


def open_compressed(path: str, compression: str | None = "auto", level: int | None = None,
                    threads: int = -1) -> BinaryIO:
    """Open ``path`` for writing: ``compression`` is ``"gzip"``, ``"zstd"``,
    ``None`` (plain) or ``"auto"`` (by extension: ``.gz``, ``.zst``,
    ``.zstd``; anything else plain)."""
    if compression == "auto":
        compression = infer_compression(path)
    try:
        raw = open(path, "wb")
    except OSError as e:
        raise IbuIoError(e) from e
    if compression is None:
        return raw
    try:
        return wrap_compress(raw, compression, level, threads)
    except Exception:
        raw.close()
        raise
