"""The yardstick of the kernel shares: the bytes each job needs and the
card's peak.

A job's bytes are counted from its record count ``n`` and the header's
widths, each input read once and each output written once, whatever kernel
does the work. A share is those bytes over the summed time of all kernels on
the card inside the jobs' spans, over the peak: never matched by kernel
name, so a later kernel that does the same work is held to the same count.
"""

from __future__ import annotations

#: NVIDIA's published device-memory bandwidth of the H100 SXM, GB/s (the
#: figure of ``ibu_tpu_torch/labs/_harness.py``)
PEAK_GBPS = 3350.0
#: bytes of one record: three u64 words
RECORD_BYTES = 24


def codec_bytes(n: int, bc_len: int, umi_len: int) -> int:
    """Encode then decode ``n`` records: ASCII rows and an 8-byte index in,
    24-byte records out, and back (120 B a record at 16/12)."""
    return n * 2 * (bc_len + umi_len + 8 + RECORD_BYTES)


def fold_bytes(n: int, bc_len: int = 0, umi_len: int = 0) -> int:
    """The stats fold reads each record once; its state is a few words."""
    return n * RECORD_BYTES


def sort_bytes(n: int, bc_len: int = 0, umi_len: int = 0) -> int:
    """A sort reads the records and writes them in order."""
    return n * 2 * RECORD_BYTES


def hist_bytes(n: int, bc_len: int = 0, umi_len: int = 0) -> int:
    """A barcode histogram reads each record's barcode word; its table of
    distinct barcodes is small beside the reads."""
    return n * 8


#: the byte model of each job kind
JOB_BYTES = {
    "roundtrip": codec_bytes,
    "stream_stats": fold_bytes,
    "sort": sort_bytes,
    "histogram": hist_bytes,
}


def share_pct(nbytes: float, kernel_s: float) -> float | None:
    """Percent of the peak that moving ``nbytes`` in ``kernel_s`` seconds
    reaches; None where no kernel time was read."""
    if kernel_s <= 0:
        return None
    return 100.0 * nbytes / kernel_s / (PEAK_GBPS * 1e9)


def job_share_pct(summary: dict, job: str) -> float | None:
    """The share of the traced jobs of kind ``job``: bytes of every traced
    job over all kernel time inside their spans. None in a run of another
    job, or where the trace holds no kernel."""
    if summary["job"] != job:
        return None
    nbytes = JOB_BYTES[job](summary["records_per_job"], summary["bc_len"], summary["umi_len"])
    return share_pct(nbytes * len(summary["jobs"]), summary["kernel_s"])
