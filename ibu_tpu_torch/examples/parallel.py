"""Parallel processing benchmark, the counterpart of the JAX package's
``examples/parallel.py`` (itself the reference's ``examples/parallel.rs``):
write a patterned file (barcode = i mod 1M, umi = 2i, index = i, sorted
flag set), map it, and compute the three field sums, checking the index sum
against its closed form n(n-1)/2. Two engines run the same work:

* ``--engine host``: host threads over the map with the reference's shard
  partition (:func:`ibu_tpu_torch.process_parallel` with a batch processor);
* ``--engine device`` (default): the file streamed to the device and summed
  there (:func:`ibu_tpu_torch.parallel.device.stream_file_stats`).

    python -m ibu_tpu_torch.examples.parallel [--records 10] [--engine both] [--device cpu]

``--records`` is in millions (the reference's headline run is 1000). Without
a CUDA card it exits 2 unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import threading
import time

import numpy as np

from ibu_tpu_torch import BatchProcessor, MmapReader, process_parallel
from ibu_tpu_torch.utils.datagen import parallel_fields, write_patterned_file
from ibu_tpu_torch.utils.device import select_device
U64_MASK = (1 << 64) - 1


def write_file(filename: str, num_records: int) -> None:
    """The patterned file, in 4M-record batches, sorted flag set."""
    start = time.perf_counter()
    write_patterned_file(filename, num_records, parallel_fields, sorted_flag=True)
    dur = time.perf_counter() - start
    print(f"  Wrote {num_records} records in {dur:.2f}s "
          f"({num_records * 24 / dur / 1e9:.2f} GB/s)")


def run_host_engine(reader: MmapReader, threads: int) -> tuple[int, int, int]:
    totals = [0, 0, 0]
    lock = threading.Lock()

    class Sums(BatchProcessor):
        def __init__(self):
            self.local = [0, 0, 0]

        def process_batch(self, records):
            for k, field in enumerate(("barcode", "umi", "index")):
                self.local[k] += int(records[field].sum(dtype=np.uint64))

        def on_batch_complete(self):
            with lock:
                for k in range(3):
                    totals[k] += self.local[k]
            self.local = [0, 0, 0]

    process_parallel(reader, Sums(), threads)
    return tuple(t & U64_MASK for t in totals)


def run_device_engine(reader: MmapReader, device) -> tuple[int, int, int]:
    from ibu_tpu_torch.parallel.device import stream_file_stats

    stats = stream_file_stats(reader, device=device)
    return stats["barcode_sum"], stats["umi_sum"], stats["index_sum"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--records", type=float, default=10.0,
                    help="records in millions (reference uses 1000)")
    ap.add_argument("--engine", choices=["host", "device", "both"], default="device")
    ap.add_argument("--threads", type=int, default=0,
                    help="host engine thread count (0 = all cores)")
    ap.add_argument("--file", default="test_parallel.ibu")
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda, cuda:N or cpu (default: the current CUDA card)")
    args = ap.parse_args(argv)
    num_records = int(args.records * 1_000_000)
    engines = ["host", "device"] if args.engine == "both" else [args.engine]
    device = None
    if "device" in engines:
        device = select_device(args.device, "parallel")
        if device is None:
            return 2

    print("IBU Parallel Processing Test")
    print("============================")
    write_file(args.file, num_records)
    reader = MmapReader(args.file)
    want_idx = num_records * (num_records - 1) // 2  # the index sum's closed form

    for engine in engines:
        start = time.perf_counter()
        if engine == "host":
            sums = run_host_engine(reader, args.threads)
        else:
            sums = run_device_engine(reader, device)
        dur = time.perf_counter() - start
        ok = sums[2] == (want_idx & U64_MASK)
        print(f"  [{engine}] processed {num_records} records in {dur:.2f}s "
              f"({num_records / dur / 1e6:.1f} M rec/s, "
              f"{num_records * 24 / dur / 1e9:.2f} GB/s) "
              f"checksum {'OK' if ok else 'MISMATCH'}")
        if not ok:
            raise SystemExit(f"checksum mismatch: {sums}")

    if not args.keep:
        os.remove(args.file)
        print("✓ complete - file cleaned up")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
