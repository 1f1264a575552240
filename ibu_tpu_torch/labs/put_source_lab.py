"""Does a put's rate depend on where its host bytes live?

    python -m ibu_tpu_torch.labs.put_source_lab [--batch-records 1048576] [--reps 4]
        [--workdir DIR] [--device cpu]

The counterpart of ``tools/put_source_lab.py``. It writes a patterned file
of ``(reps + 1) * B`` records (:func:`ibu_tpu_torch.utils.datagen.parallel_fields`)
in ``/dev/shm`` (where it has room, else a temporary directory;
``--workdir`` chooses), maps it, and
puts ``B``-record batches on the card from five sources, each put ``r``
reading region ``r`` of the file, after one untimed put from the last region:

- ``mmview``: the zero-copy ``(B, 3)`` int64 view of the mapping, copied
  with ``Tensor.to(device, non_blocking=True)``: pageable memory, so the
  copy is synchronous and goes through CUDA's own staging buffer;
- ``mmcopy``: ``np.array(view)``, a heap copy made per put, then the same;
- ``staged``: ``np.copyto`` into a preallocated pinned buffer, then an
  asynchronous copy;
- ``fresh``: heap numpy arrays of ``default_rng(3)`` bytes (pageable);
- ``production``: :func:`ibu_tpu_torch.ops.u64.to_device` of the view (a
  pinned buffer from the caching host allocator per call).

Nothing is pinned behind the caller's back in the pageable legs. Every
placed batch is checked exactly against its source bytes before the line is
printed. Timing: host clock around each put (the host copies included)
ending in ``torch.cuda.synchronize``. One JSON line of GB/s per put and leg.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import warnings

import numpy as np
import torch

from ibu_tpu_torch.io.mmap import MmapReader
from ibu_tpu_torch.labs import _capacity as C
from ibu_tpu_torch.ops.u64 import to_device, wire_view
from ibu_tpu_torch.utils.datagen import parallel_fields, write_patterned_file

SEED = 3
RECORD_BYTES = 24


def pageable(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor over ``arr``'s memory, read-only mappings included
    (nothing writes through it)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(arr)


def run(device, b: int, reps: int, workdir: str | None) -> dict:
    nbytes = b * RECORD_BYTES
    wd = C.scratch_dir("ibu_src_", (reps + 1) * nbytes, workdir)
    C.log(f"put_source_lab: {C.device_name(device)}, {reps} puts of {nbytes / 1e6:.1f} MB a leg")
    try:
        path = os.path.join(wd, "src.ibu")
        write_patterned_file(path, b * (reps + 1), parallel_fields)
        reader = MmapReader(path)
        views = [wire_view(reader.slice(r * b, (r + 1) * b)) for r in range(reps + 1)]
        rng = np.random.default_rng(SEED)
        fresh = [np.frombuffer(bytearray(rng.bytes(nbytes)), np.int64).reshape(b, 3)
                 for _ in range(reps + 1)]
        staging = torch.empty((b, 3), dtype=torch.int64, pin_memory=C.on_card(device))

        def staged(view):
            np.copyto(staging.numpy(), view)
            return staging.to(device, non_blocking=True)

        legs = {
            "mmview": (views, lambda v: pageable(v).to(device, non_blocking=True)),
            "mmcopy": (views,
                       lambda v: torch.from_numpy(np.array(v)).to(device, non_blocking=True)),
            "staged": (views, staged),
            "fresh": (fresh, lambda a: torch.from_numpy(a).to(device, non_blocking=True)),
            "production": (views, lambda v: to_device(v, device)),
        }
        out = {"batch_records": b, "MB": nbytes / 1e6, "reps": reps}
        for name, (sources, put) in legs.items():
            put(sources[reps])
            C.sync(device)  # warm: the last region
            rates = []
            for src in sources[:reps]:
                dev, dt = C.clocked(lambda src=src: put(src), device)
                rates.append(nbytes / dt / 1e9)
                C.require(C.holds(dev, src), f"a {name} put")
            out[name] = rates
            C.log(f"  {name}: checked")
            C.log_time(device, f"    {[round(r, 2) for r in rates]} GB/s")
        del reader, views
    finally:
        shutil.rmtree(wd, ignore_errors=True)
    if not C.on_card(device):
        out = {k: out[k] for k in ("batch_records", "MB", "reps")}
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ibu_tpu_torch.labs.put_source_lab",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--batch-records", type=int, default=1 << 20)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--workdir", default=None, help="where the file goes (default /dev/shm)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu: the checks, no timing")
    args = ap.parse_args(argv)
    device = C.lab_device(args.device, ap.prog)
    if device is None:
        return 2
    C.emit(run(device, args.batch_records, args.reps, args.workdir), device, C.HOST_CLOCK)
    return 0


if __name__ == "__main__":
    sys.exit(main())
