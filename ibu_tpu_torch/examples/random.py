"""Generate a random IBU file, the counterpart of the JAX package's
``examples/random.py`` (itself the reference's ``examples/random.rs``): the
same flags, the same record distribution (barcode below ``--barcodes``,
index below ``--max-index``, UMI uniform over u64) and the same bandwidth
report on stderr. The records are drawn on the device in 4M-record batches
from a generator seeded with ``--seed``.

    python -m ibu_tpu_torch.examples.random out.ibu [--records 1] [--device cpu]

``--records`` is in millions. Without a CUDA card it exits 2 unless given
``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ibu_tpu_torch import HEADER_SIZE, RECORD_SIZE, Header, Writer
from ibu_tpu_torch.ops.u64 import records_from_tensor
from ibu_tpu_torch.utils.device import select_device

CHUNK = 4 * 1024 * 1024  # records per generated batch


def random_records(n: int, barcodes: int, max_index: int, gen: torch.Generator,
                   device: torch.device) -> torch.Tensor:
    """``(n, 3)`` int64 records on ``device``: barcode in ``[0, barcodes)``,
    a UMI over all 64 bits (two 32-bit halves), index in
    ``[0, max_index)``."""
    def draw(high: int) -> torch.Tensor:
        return torch.randint(0, high, (n,), generator=gen, device=device, dtype=torch.int64)

    umi = (draw(1 << 32) << 32) | draw(1 << 32)
    return torch.stack([draw(barcodes), umi, draw(max_index)], dim=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("path", help="Output file path")
    ap.add_argument("--records", type=float, default=1.0,
                    help="Number of records to generate (in millions)")
    ap.add_argument("--barcodes", type=int, default=1_000)
    ap.add_argument("--max-index", type=int, default=10_000)
    ap.add_argument("--bc-len", type=int, default=16)
    ap.add_argument("--umi-len", type=int, default=12)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="cuda, cuda:N or cpu (default: the current CUDA card)")
    args = ap.parse_args(argv)

    device = select_device(args.device, "random")
    if device is None:
        return 2
    header = Header.new(args.bc_len, args.umi_len)
    header.validate()

    gen = torch.Generator(device=device)
    if args.seed is None:
        gen.seed()
    else:
        gen.manual_seed(args.seed)
    num_records = int(args.records * 1_000_000)

    start = time.perf_counter()
    with Writer.from_path(args.path, header) as writer:
        remaining = num_records
        while remaining > 0:
            n = min(remaining, CHUNK)
            writer.write_batch(records_from_tensor(
                random_records(n, args.barcodes, args.max_index, gen, device)))
            remaining -= n
    elapsed = time.perf_counter() - start

    total_bytes = HEADER_SIZE + num_records * RECORD_SIZE
    print(f"Finished generating {num_records} records", file=sys.stderr)
    print(f"Elapsed time: {elapsed:.3f}s", file=sys.stderr)
    print(f"Bandwidth: {total_bytes / elapsed / 1e9:.2f} Gb/s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
