"""Host-side partitioning helpers.

A copy of :func:`ibu_tpu.parallel.host.partition` and
:func:`ibu_tpu.parallel.host.resolve_num_threads`, with the reference
engine's rules (``src/io/mmap.rs:292-307``). (The host thread engine itself,
``process_parallel``, is not part of the port yet.)
"""

from __future__ import annotations

import os


def resolve_num_threads(num_threads: int) -> int:
    """``0`` → all cores; else clamp to the core count (ref
    ``mmap.rs:292-296``). A negative count is rejected: it would silently
    process nothing."""
    if num_threads < 0:
        raise ValueError(f"num_threads must be >= 0, got {num_threads}")
    cpus = os.cpu_count() or 1
    if num_threads == 0:
        return cpus
    return min(num_threads, cpus)


def partition(n: int, num_shards: int) -> list[tuple[int, int]]:
    """Static contiguous partition with the remainder appended to the last
    shard (ref ``mmap.rs:297-307``), so shard boundaries are the reference
    engine's per-thread record ranges."""
    if num_shards <= 0:
        raise ValueError(f"num_shards must be positive, got {num_shards}")
    per = n // num_shards
    rem = n % num_shards
    bounds = []
    for i in range(num_shards):
        start = i * per
        end = start + per + (rem if i == num_shards - 1 else 0)
        bounds.append((start, end))
    return bounds
