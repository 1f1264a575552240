"""Error taxonomy of the IBU format.

A copy of :mod:`ibu_tpu.errors`, so that the port runs without the JAX
package beside it: one exception class per variant of the reference's error
enum (``src/error.rs:56-128``), with the same payload fields and, character
for character, the same messages. All errors derive from :class:`IbuError`,
except the port's own :class:`NoCardError`.
"""

from __future__ import annotations


class IbuError(Exception):
    """Base class for all IBU errors (ref ``error.rs:57``)."""


class IbuIoError(IbuError):
    """Wraps an OS-level I/O failure (ref ``error.rs:62-63``)."""

    def __init__(self, inner: BaseException | str):
        self.inner = inner
        super().__init__("I/O error")


class CompressionError(IbuError):
    """Compression/decompression failure.

    The reference names this ``Niffler`` after its decompression crate
    (ref ``error.rs:69-70``); here it covers the gzip/zstd host codecs.
    """

    def __init__(self, inner: BaseException | str):
        self.inner = inner
        super().__init__("Niffler error")


class InvalidMagicNumber(IbuError):
    """File does not start with the IBU magic (ref ``error.rs:76-77``)."""

    def __init__(self, expected: int, actual: int):
        self.expected = expected
        self.actual = actual
        super().__init__(
            f"Invalid magic number, expected ({expected:#x}), found ({actual:#x})"
        )


class TruncatedRecord(IbuError):
    """Stream ended mid-record (ref ``error.rs:83-84``).

    ``pos`` is the absolute byte offset of the first incomplete record,
    matching the reference's accounting (``reader.rs:232-236``).
    """

    def __init__(self, pos: int):
        self.pos = pos
        super().__init__(f"Truncated record at position {pos}")


class InvalidVersion(IbuError):
    """Unsupported format version (ref ``error.rs:90-91``)."""

    def __init__(self, expected: int, actual: int):
        self.expected = expected
        self.actual = actual
        super().__init__(
            f"Invalid version found, expected ({expected}), found ({actual})"
        )


class InvalidBarcodeLength(IbuError):
    """Barcode length outside 1..=32 (ref ``error.rs:97-98``)."""

    def __init__(self, length: int):
        self.length = length
        super().__init__(f"Invalid barcode length: {length} (must be 1-32)")


class InvalidUmiLength(IbuError):
    """UMI length outside 1..=32 (ref ``error.rs:104-105``)."""

    def __init__(self, length: int):
        self.length = length
        super().__init__(f"Invalid UMI length: {length} (must be 1-32)")


class InvalidMapSize(IbuError):
    """Record region size not a multiple of 24 (ref ``error.rs:111-112``)."""

    def __init__(self):
        super().__init__("Invalid map size - not a multiple of record size")


class InvalidIndex(IbuError):
    """Slice bounds out of range (ref ``error.rs:118-119``)."""

    def __init__(self, idx: int, max: int):
        self.idx = idx
        self.max = max
        super().__init__(f"Invalid index ({idx}) - Must be less than {max}")


class ProcessError(IbuError):
    """User-processor failure (ref ``error.rs:126-127``)."""

    def __init__(self, inner: BaseException | str):
        self.inner = inner
        super().__init__(f"Processing error: {inner}")


def into_ibu_error(err: BaseException) -> IbuError:
    """Any exception as an :class:`IbuError`, the reference's blanket
    ``IntoIbuError`` (``error.rs:161-177``): an IBU error passes through,
    anything else is wrapped in :class:`ProcessError`."""
    if isinstance(err, IbuError):
        return err
    return ProcessError(err)


#: what a command prints after its name when it needs a card and has none
NO_CARD_HINT = ("no CUDA card (torch.cuda.is_available() is false); "
                "pass --device cpu to run the plain torch versions on the CPU")


class NoCardError(RuntimeError):
    """A CUDA device was asked for (``device=None``, the default, included)
    and no card is available (raised by
    :func:`ibu_tpu_torch.utils.device.resolve_device`). A command reports it
    as one line, :data:`NO_CARD_HINT`, and exits 2."""
