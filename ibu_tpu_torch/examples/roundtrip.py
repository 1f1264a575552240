"""IBU write → stream-read → bulk-load roundtrip, the counterpart of the JAX
package's ``examples/roundtrip.py`` (itself the reference's
``examples/roundtrip.rs``): the same patterned records (barcode = i % 1M,
umi = 31·i % 1M, index = i), the same XOR checksum, the same per-phase
M records/s + GB/s report. Batch-first throughout; the XOR reduction of each
batch runs on the device.

    python -m ibu_tpu_torch.examples.roundtrip [--records 5] [--device cpu]

Default 5M records; pass ``--records 500`` (millions) for the reference's
full 12 GB workload. Without a CUDA card it exits 2 unless given
``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ibu_tpu_torch import Header, Reader, Writer, make_records
from ibu_tpu_torch.io import load_to_vec
from ibu_tpu_torch.ops.u64 import U64_MASK, records_to_tensor
from ibu_tpu_torch.utils.datagen import roundtrip_fields
from ibu_tpu_torch.utils.device import select_device

CHUNK = 4 * 1024 * 1024


def patterned_batch(start: int, n: int) -> np.ndarray:
    i = np.arange(start, start + n, dtype=np.uint64)
    return make_records(*roundtrip_fields(i))


def xor_checksum(batch: np.ndarray, device) -> int:
    """XOR of every field of every record of ``batch``, reduced on
    ``device`` over the ``(N, 3)`` int64 view."""
    words = records_to_tensor(batch, device).reshape(-1)
    if words.numel() == 0:
        return 0
    # torch has no xor reduction: pad with zeros to a power of two and fold
    # the halves onto each other
    size = 1 << (words.numel() - 1).bit_length()
    words = torch.nn.functional.pad(words, (0, size - words.numel()))
    while words.numel() > 1:
        half = words.numel() // 2
        words = words[:half] ^ words[half:]
    return int(words[0]) & U64_MASK


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--records", type=float, default=5.0,
                    help="records in millions (reference uses 500)")
    ap.add_argument("--file", default="test_roundtrip.ibu")
    ap.add_argument("--keep", action="store_true", help="don't delete the file")
    ap.add_argument("--device", default=None,
                    help="cuda, cuda:N or cpu (default: the current CUDA card)")
    args = ap.parse_args(argv)
    num_records = int(args.records * 1_000_000)
    filename = args.file

    device = select_device(args.device, "roundtrip")
    if device is None:
        return 2

    print("IBU Roundtrip Test")
    print("==================")
    print(f"Records: {num_records}")
    print(f"File size: ~{num_records * 24 / 1e9:.2f} GB\n")

    header = Header.new(16, 12)
    header.set_sorted()

    # ========== WRITE ==========
    print("Writing...")
    write_start = time.perf_counter()
    with Writer.from_path(filename, header) as writer:
        for start in range(0, num_records, CHUNK):
            writer.write_batch(patterned_batch(start, min(CHUNK, num_records - start)))
    write_dur = time.perf_counter() - write_start
    print("  ✓ Write complete")
    print(f"  Duration: {write_dur:.2f}s")
    print(f"  Rate: {num_records / write_dur / 1e6:.2f} M records/s")
    print(f"  Bandwidth: {num_records * 24 / write_dur / 1e9:.2f} GB/s\n")

    # ========== STREAMING READ ==========
    print("Reading...")
    read_start = time.perf_counter()
    reader = Reader.from_path(filename)
    read_header = reader.header()
    assert read_header.bc_len == header.bc_len
    assert read_header.umi_len == header.umi_len
    assert read_header.sorted() == header.sorted()

    records_read = 0
    checksum = 0
    for batch in reader.batches():
        records_read += len(batch)
        checksum ^= xor_checksum(batch, device)
    read_dur = time.perf_counter() - read_start
    print("  ✓ Read complete")
    print(f"  Duration: {read_dur:.2f}s")
    print(f"  Rate: {records_read / read_dur / 1e6:.2f} M records/s")
    print(f"  Bandwidth: {records_read * 24 / read_dur / 1e9:.2f} GB/s\n")

    # ========== VERIFICATION ==========
    print("Verification:")
    print(f"  Records written: {num_records}")
    print(f"  Records read: {records_read}")
    print(f"  Checksum: 0x{int(checksum):016X}")
    assert records_read == num_records, "Record count mismatch!"
    print("  ✓ Record count matches\n")

    # ========== DIRECT LOAD ==========
    load_start = time.perf_counter()
    _header, records = load_to_vec(filename)
    load_dur = time.perf_counter() - load_start
    print("Direct Load:")
    print(f"  Duration: {load_dur:.2f}s")
    print(f"  Rate: {len(records) / load_dur / 1e6:.2f} M records/s")
    print(f"  Bandwidth: {len(records) * 24 / load_dur / 1e9:.2f} GB/s\n")

    if not args.keep:
        os.remove(filename)
        print("✓ Test complete - file cleaned up")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
