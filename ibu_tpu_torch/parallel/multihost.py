"""Cohorts of processes over ``torch.distributed``: one rank per process,
one card per rank.

Counterpart of :mod:`ibu_tpu.parallel.multihost`. The JAX package's global
mesh becomes the ``torch.distributed`` world, and its shard ``g`` is rank
``g`` here. As there:

* each rank opens the file itself and reads **only its own record range**,
  by the reference partition rule (contiguous, remainder to the last rank);
* per-rank states merge at the end, in one collective;
* a failure on one rank reaches the next collective **as data**
  (:func:`_cohort_checkpoint`), so every rank raises together instead of
  leaving the others waiting in a collective.

Two process groups carry the cohort's traffic:

* a **Gloo** group, always: the host lanes (checkpoints, sample and count
  gathers, the engine agreement, the state merges), where the JAX package
  used ``multihost_utils.process_allgather``;
* an **NCCL** group, only when every rank has a card of its own: the device
  tensors of the sample sort's exchange. The ranks decide it from their host
  names and card UUIDs, gathered over Gloo, so the choice is the same on every
  rank (:func:`exchange_backend`). Where two ranks share a card (NCCL refuses
  that), device tensors go over Gloo through pinned host buffers.

The engines: statistics, the barcode histogram and any ``MapReduce``
(per-rank states merged at the end), the sorted rewrite (the mesh sample sort
or the shared-filesystem external sort), and the file engines, each rank
streaming its own range and ``pwrite``-ing its part of one shared output at
offsets from one gather: dedup, filter and correct (on
:func:`_multihost_rewrite`), the count matrix (its barcode ranges exchanged
through part files) and FASTQ ingest; FASTQ export writes one shard per rank.
Gathered lanes are int64; words compared after a gather (the rewrite's
boundary triples, the count's barcode samples) travel as their bits and are
viewed back to uint64 first, since a 32-base barcode sets bit 63.

A process that never joined a group is a world of size 1, and every engine
then takes its single-process path, as the JAX package's do when
``jax.process_count() == 1``. ``process_local_placer`` and
``local_soa_batches`` have no counterpart: each rank places its own block on
its own card, and the ``(6, N)`` column layout is the TPU's.
"""

from __future__ import annotations

import os
import socket
import struct
import sys
from typing import Iterator

import numpy as np
import torch
import torch.distributed as dist

from ibu_tpu_torch.constructs.header import HEADER_SIZE, Header
from ibu_tpu_torch.constructs.record import RECORD_SIZE
from ibu_tpu_torch.io.mmap import STREAM_BATCH_RECORDS, MmapReader
from ibu_tpu_torch.parallel.device import STATS_MAP_REDUCE, finalize_stats
from ibu_tpu_torch.parallel.host import partition
from ibu_tpu_torch.utils.device import resolve_device

#: the cohort's groups, rebuilt whenever the default group changes
_COHORT: dict = {}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def process_count() -> int:
    """Ranks in the cohort; 1 for a process that joined no group."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank; 0 for a process that joined no group."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _card_identity() -> str:
    """This rank's card as ``host/uuid``; empty without a card."""
    if not torch.cuda.is_available():
        return ""
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    return f"{socket.gethostname()}/{props.uuid}"


def _groups() -> dict:
    """The cohort's Gloo group and, where every rank has a card of its own,
    its NCCL group. Built on first use after the default group is made, by a
    collective, so every rank calls it at the same point: the first cohort
    step of every engine does."""
    world = dist.group.WORLD
    if _COHORT.get("world") is world:
        return _COHORT
    backend = dist.get_backend()
    gloo = world if backend == "gloo" else dist.new_group(backend="gloo")
    cards: list = [None] * dist.get_world_size()
    dist.all_gather_object(cards, _card_identity(), group=gloo)
    own = all(cards) and len(set(cards)) == len(cards)
    nccl = None
    if own:
        nccl = world if backend == "nccl" else dist.new_group(backend="nccl")
    _COHORT.clear()
    _COHORT.update(world=world, gloo=gloo, nccl=nccl, cards=cards)
    return _COHORT


def exchange_backend(device: str | torch.device | None = None) -> str | None:
    """The backend that carries device tensors between the ranks of the
    cohort: ``"nccl"`` when ``device`` is a card and every rank has a card of
    its own, ``"gloo"`` otherwise (a card's tensors then pass through pinned
    host buffers); ``None`` outside a cohort. The same on every rank, since
    it comes from the gathered card identities. Prints nothing."""
    device = resolve_device(device)
    if not dist.is_initialized():
        return None
    nccl = _groups()["nccl"]
    return "nccl" if device.type == "cuda" and nccl is not None else "gloo"


def _allgather_host(arr: np.ndarray) -> np.ndarray:
    """Every rank's ``arr`` (the same shape and dtype on every rank), stacked
    ``(P, ...)`` by rank, over the Gloo group; ``arr[None]`` outside a
    cohort."""
    arr = np.array(arr, order="C")
    if not dist.is_initialized():
        return arr[None]
    mine = torch.from_numpy(arr)
    out = [torch.empty_like(mine) for _ in range(process_count())]
    dist.all_gather(out, mine, group=_groups()["gloo"])
    return np.stack([t.numpy() for t in out])


def _allgather_varlen(arr: np.ndarray, lengths) -> list[np.ndarray]:
    """Every rank's ``arr`` of ``lengths[r]`` columns along its last axis
    (the other dimensions the same on every rank), as a list by rank. The
    lengths come from an earlier gather, so every rank pads to the same
    width."""
    width = int(max(lengths)) if len(lengths) else 0
    pad = np.zeros(arr.shape[:-1] + (width,), dtype=arr.dtype)
    pad[..., : arr.shape[-1]] = arr
    gathered = _allgather_host(pad)
    return [gathered[r][..., : int(n)] for r, n in enumerate(lengths)]


def _raise_if_failed(flags, failed: BaseException | None, stage: str) -> None:
    if np.asarray(flags).any():
        if failed is not None:
            raise failed
        raise ValueError(
            f"multihost operation failed on another process during "
            f"{stage} (see that rank's error)"
        )


def _cohort_checkpoint(failed: BaseException | None, stage: str, extra=()) -> np.ndarray:
    """Collective failure gate (the cohort rule: any local failure must
    reach the next collective AS DATA, not as control flow; a lone rank
    raising before a collective leaves the rest waiting in it).

    All-gathers a failure flag plus optional int64 lanes (the same number
    on every rank; uint64 lanes travel as their bits); if ANY rank failed,
    every rank raises together (its own exception, or a pointer to the
    failing rank). On success returns the gathered extra lanes as an
    ``(nprocs, len(extra))`` int64 array. The all-gather doubles as a
    barrier.
    """
    extra = np.asarray(extra).reshape(-1)
    if extra.dtype == np.uint64:
        extra = extra.view(np.int64)
    lane = np.concatenate([[int(failed is not None)], extra.astype(np.int64)])
    gathered = _allgather_host(lane)
    _raise_if_failed(gathered[:, 0], failed, stage)
    return gathered[:, 1:]


def _even_sample_positions(n: int, s: int) -> np.ndarray:
    """``s`` evenly-spaced positions in ``[0, n)`` (``(2k+1)·n/2s``): the
    sampling rule of the host sort's splitter election."""
    pos = ((np.arange(s) + 0.5) * n / s).astype(np.int64)
    return np.minimum(pos, max(n - 1, 0))


def _splitter_cut_indices(total: int, nprocs: int) -> np.ndarray:
    """Quantile cut positions into a sorted sample array: splitter
    ``d`` sits at ``d·total/nprocs`` for ``d = 1..nprocs-1``."""
    return (np.arange(1, nprocs) * total) // nprocs


def _pwrite_all(fd: int, data, offset: int) -> None:
    """``os.pwrite`` until every byte lands: pwrite may return short
    (ENOSPC after partial progress, a signal, shared filesystems); advancing
    by the intended length would leave the tail as the pre-truncated zeros
    while the run reports success."""
    view = memoryview(data).cast("B")
    while len(view):
        written = os.pwrite(fd, view, offset)
        view = view[written:]
        offset += written


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Join the cohort (no-op when single-process).

    Every rank calls it once before any cohort work, with the same
    ``coordinator_address``: ``HOST:PORT`` (rank 0's host; a ``tcp://``
    rendezvous), or any ``torch.distributed`` init URL such as
    ``file:///shared/path``. The default group is Gloo; rank ``r`` takes
    card ``r % torch.cuda.device_count()`` where there are cards. A no-op
    too when this process already is in a cohort.
    """
    if num_processes is None or num_processes <= 1 or dist.is_initialized():
        return
    url = coordinator_address
    if url and "://" not in url:
        url = f"tcp://{url}"
    dist.init_process_group(
        "gloo", init_method=url, world_size=num_processes, rank=process_id
    )
    if torch.cuda.is_available():
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())


def local_record_range(total_records: int) -> tuple[int, int]:
    """This process's contiguous record range (reference partition rule)."""
    return partition(total_records, process_count())[process_index()]


def local_record_batches(
    reader: MmapReader, batch_records: int = STREAM_BATCH_RECORDS
) -> Iterator[np.ndarray]:
    """Stream only this process's shard of the file as structured record
    batches (zero-copy mmap views)."""
    start, end = local_record_range(reader.len())
    pos = start
    while pos < end:
        stop = min(pos + batch_records, end)
        yield reader.slice(pos, stop)
        pos = stop


def multihost_rounds(total_records: int, local_cols: int) -> int:
    """The most batches of ``local_cols`` records any rank's range needs,
    computed locally on every rank from the file size alone (the partition
    is deterministic)."""
    return max(
        _cdiv(max(e - s, 0), local_cols)
        for s, e in partition(total_records, process_count())
    )


def multihost_placed_batches(
    reader: MmapReader,
    device: str | torch.device | None = None,
    batch_records: int = STREAM_BATCH_RECORDS,
    prefetch: int | None = None,
    with_hint: bool = False,
):
    """This rank's range of ``reader`` on its card: a prefetching
    :class:`ibu_tpu_torch.io.stream.DeviceStream` of ``(B, 3)`` int64
    batches (with ``with_hint``, ``(batch, bc16)`` pairs).

    The JAX package yields the SAME number of batches on every process,
    padding short ranges with empty ones, because its engines run a
    collective per batch. Here the engines merge once, at the end, so each
    rank yields only its own batches, with no padding: ranks may yield
    different counts (:func:`multihost_rounds` gives the most).
    """
    from ibu_tpu_torch.io.mmap import STREAM_PREFETCH
    from ibu_tpu_torch.io.stream import DeviceStream

    return DeviceStream(
        local_record_batches(reader, batch_records),
        device=device,
        prefetch=STREAM_PREFETCH if prefetch is None else prefetch,
        with_hint=with_hint,
    )


def multihost_map_reduce(
    path: str,
    engine,
    device: str | torch.device | None = None,
    batch_records: int = STREAM_BATCH_RECORDS,
):
    """Run any :class:`ibu_tpu_torch.parallel.device.MapReduce` over the
    cohort: every rank streams its own record range of ``path`` onto its
    card, and the per-rank states merge in one collective
    (:meth:`~ibu_tpu_torch.parallel.device.MapReduce.finalize`)."""
    reader = MmapReader(path)
    device = resolve_device(device)
    return engine.run_placed(
        multihost_placed_batches(reader, device, batch_records), device
    )


def multihost_file_stats(
    path: str,
    device: str | torch.device | None = None,
    batch_records: int = STREAM_BATCH_RECORDS,
) -> dict:
    """Count + exact u64 field checksums across every rank of the cohort.
    Every rank streams its own range; the partial states merge at the end."""
    return finalize_stats(
        multihost_map_reduce(path, STATS_MAP_REDUCE, device, batch_records)
    )


def multihost_barcode_histogram(
    path: str,
    device: str | torch.device | None = None,
    batch_records: int = STREAM_BATCH_RECORDS,
    capacity: int = 1 << 20,
    max_uniques_per_shard: int = 1 << 16,
    spill: bool = True,
) -> dict[int, int]:
    """Per-barcode counts across every rank of the cohort.

    Every rank streams its own record range into a
    :class:`~ibu_tpu_torch.parallel.device.DeviceHistogram` on its card;
    :meth:`~ibu_tpu_torch.parallel.device.DeviceHistogram.finalize` merges
    the ranks' tables and spilled counts, so every rank returns the same
    dict. Barcode spaces larger than ``capacity`` spill exactly to the host
    (``spill``). A sorted file's flag is read from the same header bytes on
    every rank and verified on the card.
    """
    from ibu_tpu_torch.parallel.device import DeviceHistogram

    reader = MmapReader(path)
    hist = DeviceHistogram(
        capacity=capacity,
        max_uniques_per_shard=max_uniques_per_shard,
        spill=spill,
        assume_sorted=reader.header().sorted(),
        device=device,
    )
    if process_count() == 1:
        return hist.run(local_record_batches(reader, batch_records))
    failed = None
    try:
        for records, bc16 in multihost_placed_batches(
            reader, hist.device, batch_records, with_hint=True
        ):
            hist.update_placed(records, bc16=bc16)
    except BaseException as e:
        failed = e
    return hist.finalize(failed)


def multihost_sort_file(
    in_path: str,
    out_path: str,
    device: str | torch.device | None = None,
    index_bits: int | None = None,
    slack: float = 2.0,
    samples_per_shard: int = 256,
    engine: str = "auto",
    chunk_records: int = 0,
    nthreads: int = 0,
) -> None:
    """Cohort-wide sorted rewrite, engine-dispatched.

    Two engines, identical byte output:

    * ``"mesh"``: the device sample sort over the cohort's cards
      (:func:`_multihost_sort_mesh`); files up to the cards' total memory
      sort on the devices;
    * ``"host"``: the shared-FS external sample sort
      (:func:`_multihost_sort_host`): per-rank native chunk sorts spill sorted
      runs, sampled splitters assign each rank a key range, and each rank
      k-way-merges its range from EVERY rank's runs straight into its slice
      of the pre-truncated output.

    ``engine="auto"`` picks mesh on a card when the file fits the cards'
    memory, host otherwise (when the native runtime is available),
    announcing on stderr; ``IBU_POD_SORT_ENGINE`` overrides globally. In a
    cohort the choice is rank 0's preference plus every rank's native
    availability, the same on every rank.
    """
    if engine == "auto":
        env = os.environ.get("IBU_POD_SORT_ENGINE") or ""
        failed = None
        why = ""
        try:
            if env:
                engine, why = env, "operator override"
            else:
                engine, why = _choose_pod_sort_engine(in_path, device)
        except BaseException as e:
            failed = e
        if process_count() > 1:
            # the choice must be COHORT-UNIFORM (the two engines run
            # different collectives): rank 0's preference, every rank's
            # native availability and any invalid override, resolved
            # identically everywhere; a bad IBU_POD_SORT_ENGINE raises on
            # EVERY rank instead of silently running mesh
            from ibu_tpu_torch import native

            g = _cohort_checkpoint(failed, "the engine choice", (
                1 if engine == "host" else 0,
                1 if native.available() else 0,
                1 if engine not in ("mesh", "host") else 0,
            ))
            if g[:, 2].any():
                raise ValueError(
                    f"IBU_POD_SORT_ENGINE must be mesh or host, got "
                    f"{engine!r} (on this or another rank)"
                )
            uniform = "host" if (g[0, 0] and g[:, 1].all()) else "mesh"
            if uniform != engine:
                why += (
                    f"; cohort agreement overrode local choice "
                    f"{engine!r} (rank-0 preference + every-rank native "
                    "availability)"
                )
            engine = uniform
        elif failed is not None:
            raise failed
        print(f"pod sort engine auto: {why} -> {engine}", file=sys.stderr)
    if engine == "host":
        return _multihost_sort_host(
            in_path, out_path, chunk_records=chunk_records, nthreads=nthreads,
        )
    if engine != "mesh":
        raise ValueError(f"engine must be auto/mesh/host, got {engine!r}")
    return _multihost_sort_mesh(
        in_path, out_path, device=device, index_bits=index_bits, slack=slack,
        samples_per_shard=samples_per_shard,
    )


def _choose_pod_sort_engine(
    in_path: str, device: str | torch.device | None = None
) -> tuple[str, str]:
    """mesh on a card when six times the file fits the cohort's cards
    (working set: dealt input, exchange buffers, merged output), else host
    (when the native runtime built), else mesh."""
    from ibu_tpu_torch import native

    device = resolve_device(device)
    if device.type == "cuda":
        nbytes = os.path.getsize(in_path)
        per_card = torch.cuda.mem_get_info(device)[1]
        cards = len(set(_groups()["cards"])) if dist.is_initialized() else 1
        budget = cards * per_card
        if nbytes * 6 <= budget:
            return "mesh", f"cuda backend, {nbytes/1e9:.1f} GB fits the cards"
        if native.available():
            return "host", (
                f"{nbytes/1e9:.1f} GB exceeds the cards' memory budget "
                f"({budget/1e9:.0f} GB/6)"
            )
        return "mesh", "file exceeds the cards' budget but no native runtime"
    if native.available():
        return "host", "cpu backend (no card): native external sort"
    return "mesh", "cpu backend but no native runtime"


def _sorted_header(header):
    out = Header.new(header.bc_len, header.umi_len)
    out.flags = header.flags
    out.set_sorted()
    return out


def _create_output(out_path: str, header, n: int) -> None:
    """Rank 0 pre-creates the full-size output behind a checkpoint, so a
    quota or permission error fails every rank together."""
    failed = None
    try:
        if process_index() == 0:
            with open(out_path, "wb") as f:
                f.write(header.as_bytes())
                f.truncate(HEADER_SIZE + RECORD_SIZE * n)
    except BaseException as e:
        failed = e
    _cohort_checkpoint(failed, "output creation")


def _finish_write(
    failed: BaseException | None, stage: str, *out_paths: str, extra=()
) -> np.ndarray:
    """The last checkpoint of a cooperative write: a failure on any rank
    unlinks the outputs on every rank, so no full-size sorted-flagged file
    with zero records in its dead ranges survives. Returns the gathered
    ``extra`` lanes, as :func:`_cohort_checkpoint` does."""
    try:
        return _cohort_checkpoint(failed, stage, extra)
    except BaseException:
        for path in out_paths:
            try:
                os.unlink(path)
            except OSError:
                pass
        raise


def _multihost_sort_host(
    in_path: str,
    out_path: str,
    chunk_records: int = 0,
    nthreads: int = 0,
    samples_per_rank: int = 256,
) -> None:
    """Cohort-wide shared-FS external sample sort (host path).

    Per rank: (1) native chunk sorts spill sorted headerless runs of MY
    record range next to ``out_path`` (shared FS); (2) every rank samples
    its runs evenly and one all-gather elects ``P-1`` full-triple
    splitters; (3) each rank binary-searches its key interval in EVERY
    rank's runs and one all-gather of interval counts yields exact output
    offsets; (4) rank 0 pre-creates the output (input header + sorted flag +
    full-size truncate); (5) each rank k-way-merges its interval from all
    runs DIRECTLY into its byte slice (``native.merge_runs_interval``).

    Every stage failure rides a cohort checkpoint; a failed cooperative
    write unlinks the output. Equal triples are byte-identical, so the
    output is byte-identical to ``native.sort_file`` for any splitter
    choice.
    """
    from ibu_tpu_torch import native
    from ibu_tpu_torch.constructs.record import RECORD_DTYPE
    from ibu_tpu_torch.pipelines import _require_plain

    if not native.available():
        raise RuntimeError(
            f"pod host sort needs the native runtime: {native.load_error()}"
        )
    if process_count() == 1:
        native.sort_file(in_path, out_path, chunk_records=chunk_records,
                         nthreads=nthreads)
        return

    _require_plain(in_path, "sort")
    reader = MmapReader(in_path)
    header = reader.header()
    n = reader.len()
    start, end = local_record_range(n)
    pid = process_index()
    nprocs = process_count()

    failed: BaseException | None = None
    run_prefix = f"{out_path}.mhsort{pid}"
    runs: list[str] = []
    try:
        # -- stage 1: sorted runs of my range --
        try:
            runs = native.sort_chunks_range(
                in_path, run_prefix, start, end - start,
                chunk_records=chunk_records, nthreads=nthreads,
            )
        except BaseException as e:
            failed = e
        gathered = _cohort_checkpoint(failed, "the run sort", (len(runs),))
        all_runs = [
            f"{out_path}.mhsort{r}.run{k}"
            for r in range(nprocs)
            for k in range(int(gathered[r, 0]))
        ]

        # -- stage 2: splitter election (evenly-spaced triples over my
        # sorted runs' concatenation; padding sorts last) --
        samples = np.full((samples_per_rank, 3), np.uint64(native.U64_MAX), dtype=np.uint64)
        try:
            sizes = [os.path.getsize(r) // RECORD_SIZE for r in runs]
            tot = sum(sizes)
            if tot:
                bounds = np.concatenate([[0], np.cumsum(sizes)])
                pos = _even_sample_positions(tot, samples_per_rank)
                which = np.searchsorted(bounds, pos, side="right") - 1
                for i, (w, p) in enumerate(zip(which, pos)):
                    rec = np.memmap(runs[int(w)], dtype=RECORD_DTYPE, mode="r")[int(p - bounds[w])]
                    samples[i] = (rec["barcode"], rec["umi"], rec["index"])
        except BaseException as e:
            failed = e
        g_samp = _cohort_checkpoint(failed, "the splitter election", samples)
        g_samp = g_samp.view(np.uint64).reshape(nprocs * samples_per_rank, 3)
        key_view = np.zeros(len(g_samp), dtype=RECORD_DTYPE)
        key_view["barcode"], key_view["umi"], key_view["index"] = (
            g_samp[:, 0], g_samp[:, 1], g_samp[:, 2]
        )
        key_sorted = np.sort(key_view, order=("barcode", "umi", "index"))
        sp_at = _splitter_cut_indices(len(key_sorted), nprocs)
        splitters = [
            (int(r["barcode"]), int(r["umi"]), int(r["index"]))
            for r in key_sorted[sp_at]
        ]
        lo = (0, 0, 0) if pid == 0 else splitters[pid - 1]
        hi = None if pid == nprocs - 1 else splitters[pid]

        # -- stage 3: my interval counts over ALL runs → exact offsets --
        my_count = 0
        try:
            for r in all_runs:
                a, b_ = native.run_interval(r, lo, hi)
                my_count += b_ - a
        except BaseException as e:
            failed = e
        gathered = _cohort_checkpoint(failed, "the interval count", (my_count,))
        counts = [int(v) for v in gathered[:, 0]]
        assert sum(counts) == n, (counts, n)
        my_offset = HEADER_SIZE + RECORD_SIZE * sum(counts[:pid])

        # -- stage 4: rank 0 creates the full-size output --
        _create_output(out_path, _sorted_header(header), n)

        # -- stage 5: merge my interval straight into my byte slice --
        try:
            if my_count:
                native.merge_runs_interval(
                    all_runs, lo, hi, out_path, my_offset,
                    nthreads=nthreads, expect_records=my_count,
                )
        except BaseException as e:
            failed = e
        _finish_write(failed, "the merge write", out_path)
    finally:
        for r in runs:
            try:
                os.unlink(r)
            except OSError:
                pass


def _multihost_sort_mesh(
    in_path: str,
    out_path: str,
    device: str | torch.device | None = None,
    index_bits: int | None = None,
    slack: float = 2.0,
    samples_per_shard: int = 256,
) -> None:
    """Cohort-wide sorted rewrite: the device sample sort over every rank's
    card (:mod:`ibu_tpu_torch.parallel.sort`).

    Host plumbing per rank (``out_path`` must be on a filesystem every rank
    shares):

    * stride-dealt READS: rank ``g`` owns record positions ``g, g+S, …``
      (the placement rule of the single-process engine), so each rank reads
      only its own strided subset of the input mmap;
    * each rank ``pwrite``s its sorted run at the byte offset the gathered
      per-rank counts give; rank 0 pre-creates the file (header + full-size
      truncate) behind a checkpoint, so every byte is written exactly once.
    """
    from ibu_tpu_torch.ops.u64 import records_to_tensor, to_host
    from ibu_tpu_torch.parallel import sort as MS
    from ibu_tpu_torch.pipelines import _require_plain

    if process_count() == 1:
        MS.sort_file_mesh(in_path, out_path, device=device,
                          index_bits=index_bits, slack=slack)
        return

    _require_plain(in_path, "sort")
    device = resolve_device(device)
    s, pid = process_count(), process_index()
    reader = MmapReader(in_path)
    header = reader.header()
    records = reader.records  # mmap view: no bulk copy
    b = reader.len()

    # hints: the same on every rank (the index probe scans the shared mmap)
    if index_bits is None:
        idx_hi = np.asarray(records["index"]) >> np.uint64(32)
        index_bits = 32 if not idx_hi.any() else None
    hi_used = MS._hi_used(header.bc_len, header.umi_len, index_bits)
    run, matrix = MS._sample_sort(
        lambda: records_to_tensor(np.ascontiguousarray(records[pid::s]), device),
        b, hi_used, slack, samples_per_shard, check_records=records,
    )
    counts = matrix.sum(axis=0)
    assert int(counts.sum()) == b, (counts, b)
    offsets = HEADER_SIZE + RECORD_SIZE * np.concatenate([[0], np.cumsum(counts)[:-1]])

    _create_output(out_path, _sorted_header(header), b)
    failed: BaseException | None = None
    try:
        fd = os.open(out_path, os.O_WRONLY)
        try:
            _pwrite_all(fd, to_host(run), int(offsets[pid]))
        finally:
            os.close(fd)
    except BaseException as e:
        failed = e
    _finish_write(failed, "the write pass", out_path)


def multihost_dedup_file(
    in_path: str,
    out_path: str,
    device: str | torch.device | None = None,
    assume_sorted: bool | None = None,
    batch_records: int = 4 * 1024 * 1024,
) -> dict:
    """Cohort-wide UMI dedup: one record per distinct (barcode, umi) pair.

    The cohort form of :func:`ibu_tpu_torch.pipelines.dedup_file`. An
    unsorted input is first sorted by :func:`multihost_sort_file` (on
    ``device`` with the mesh engine) into ``out_path + ".mhsort.tmp"``; the
    dedup then partitions the sorted file by the reference rule and each
    rank streams ONLY its record range:

    * the one-record carry at a range boundary is read directly from the
      shared mmap (``records[start-1]``), with no communication;
    * the count pass counts each range's kept records (verifying sort order
      like the single-process pass), and one gather turns the counts into
      exact output byte offsets; the order verdict travels in that gather,
      so a lying sorted flag fails every rank;
    * rank 0 pre-creates the output behind a checkpoint, then every rank
      ``pwrite``s its kept records at its offset.

    ``in_path`` and ``out_path`` must be on a filesystem every rank shares.
    Returns ``{"records", "molecules", "barcodes"}`` on every rank.
    """
    from ibu_tpu_torch.pipelines import (
        _dedup_batch_masks,
        _lex_nondecreasing,
        _require_plain,
        dedup_file,
    )

    if process_count() == 1:
        return dedup_file(
            in_path, out_path, batch_records=batch_records,
            assume_sorted=assume_sorted, device=device,
        )

    _require_plain(in_path, "dedup")
    reader = MmapReader(in_path)
    header = reader.header()
    # every rank reads the same header bytes and was launched with the same
    # flags, so this branch is cohort-uniform
    sorted_in = header.sorted() if assume_sorted is None else assume_sorted

    tmp = None
    try:
        if not sorted_in:
            tmp = out_path + ".mhsort.tmp"  # deterministic: shared by every rank
            multihost_sort_file(in_path, tmp, device=device)
            reader = MmapReader(tmp)
        n = reader.len()
        records = reader.records
        start, end = local_record_range(n)

        def batches_with_prev():
            prev = None
            if start > 0 and end > start:
                r = records[start - 1]
                prev = (int(r["barcode"]), int(r["umi"]), int(r["index"]))
            for pos in range(start, end, batch_records):
                batch = np.asarray(records[pos:min(pos + batch_records, end)])
                bc, umi, idx = batch["barcode"], batch["umi"], batch["index"]
                if not _lex_nondecreasing(bc, umi, idx, prev):
                    if tmp is not None:
                        raise ValueError(
                            "internal error: the pod mesh sort produced "
                            f"out-of-order output near record {pos} of "
                            f"{tmp}; please report this"
                        )
                    raise ValueError(
                        f"{in_path}: records are not in sorted order near "
                        f"record {pos} despite the sorted flag; re-sort, "
                        "or pass assume_sorted=False (CLI: "
                        "--assume-sorted no)"
                    )
                keep, bc_first = _dedup_batch_masks(bc, umi, prev)
                prev = (int(bc[-1]), int(umi[-1]), int(idx[-1]))
                yield batch, keep, bc_first

        # the order verdict travels inside the count gather: a rank raising
        # here alone would leave the others waiting in it
        kept = bc_firsts = 0
        failed: BaseException | None = None
        order_error: str | None = None
        try:
            for _, keep, bc_first in batches_with_prev():
                kept += int(keep.sum())
                bc_firsts += int(bc_first.sum())
        except ValueError as e:
            order_error = str(e)
        except BaseException as e:
            failed = e
        gathered = _cohort_checkpoint(
            failed, "the count pass", (kept, bc_firsts, int(order_error is not None))
        )
        if gathered[:, 2].any():
            raise ValueError(
                order_error
                or "records are not in sorted order in another process's "
                "record range (see that rank's error for the position)"
            )
        total_kept = int(gathered[:, 0].sum())
        my_offset = int(gathered[: process_index(), 0].sum())

        _create_output(out_path, _sorted_header(header), total_kept)
        pos_out = HEADER_SIZE + RECORD_SIZE * my_offset
        try:
            fd = os.open(out_path, os.O_WRONLY)
            try:
                for batch, keep, _ in batches_with_prev():
                    data = np.ascontiguousarray(batch[keep]).view(np.uint8)
                    _pwrite_all(fd, data, pos_out)
                    pos_out += data.nbytes
            finally:
                os.close(fd)
        except BaseException as e:
            failed = e
        _finish_write(failed, "the write pass", out_path)
    finally:
        if tmp is not None and process_index() == 0:
            # guarded: an OSError raised from finally would replace the
            # exception in flight
            try:
                os.unlink(tmp)
            except OSError:
                pass

    return {
        "records": n,
        "molecules": total_kept,
        "barcodes": int(gathered[:, 1].sum()),
    }


def _multihost_rewrite(
    reader: MmapReader,
    out_path: str,
    out_header,
    transform,
    batch_records: int,
    stat_keys: tuple = (),
    track_order: bool = False,
    spool: bool = False,
):
    """Range-partitioned streaming record rewrite across the cohort.

    The shared engine under :func:`multihost_filter_file` and
    :func:`multihost_correct_file`: the input partitions by the reference
    rule, each rank streams only its range through ``transform(batch) ->
    (out_records, {stat: int})``, one gather of kept counts (and stat sums)
    becomes exact output byte offsets, and every rank ``pwrite``s its output
    behind a create checkpoint.

    ``spool=False``: ``transform`` must be deterministic; it runs twice
    (count pass, then write pass) so memory stays bounded at one batch,
    right when the transform is cheap numpy (filter). ``spool=True``: the
    count pass writes the transformed records to a rank-local temporary file
    and the write pass copies it to the final offset, right when the
    transform dominates (correct's Hamming probe would otherwise run twice
    per record).

    With ``track_order=True`` the return includes whether the WHOLE written
    stream is lexicographically nondecreasing (each rank verifies its own
    stream; the rank-boundary pairs are checked after the gather, as
    unsigned words), so the caller can patch the sorted flag.

    Returns ``(total_kept, {stat: total}, globally_sorted | None)``.
    """
    import tempfile

    from ibu_tpu_torch.pipelines import _lex_nondecreasing

    n = reader.len()
    records = reader.records
    start, end = local_record_range(n)

    def out_batches():
        for pos in range(start, end, batch_records):
            yield transform(np.asarray(records[pos:min(pos + batch_records, end)]))

    spool_file = None
    kept = 0
    stats = dict.fromkeys(stat_keys, 0)
    local_sorted = True
    first = last = None
    failed: BaseException | None = None
    try:
        try:
            if spool:
                spool_file = tempfile.TemporaryFile(prefix="ibu_mh_rewrite_", suffix=".spool")
            for out, inc in out_batches():
                kept += len(out)
                for k in stat_keys:
                    stats[k] += int(inc.get(k, 0))
                if spool_file is not None and len(out):
                    spool_file.write(np.ascontiguousarray(out).tobytes())
                if track_order and len(out):
                    if local_sorted and not _lex_nondecreasing(
                        out["barcode"], out["umi"], out["index"], last
                    ):
                        local_sorted = False
                    tail = out[-1]
                    last = (int(tail["barcode"]), int(tail["umi"]), int(tail["index"]))
                    if first is None:
                        head = out[0]
                        first = (int(head["barcode"]), int(head["umi"]), int(head["index"]))
        except BaseException as e:
            failed = e

        # one gather: kept, stat sums, and (order-tracked) the local verdict
        # and boundary triples, as uint64 lanes
        lane = [kept] + [stats[k] for k in stat_keys]
        if track_order:
            lane += [int(local_sorted), int(first is not None)]
            lane += list(first or (0, 0, 0)) + list(last or (0, 0, 0))
        gathered = _cohort_checkpoint(
            failed, "the count pass", np.asarray(lane, dtype=np.uint64)
        ).view(np.uint64)
        total_kept = int(gathered[:, 0].sum())
        totals = {k: int(gathered[:, 1 + i].sum()) for i, k in enumerate(stat_keys)}
        globally_sorted = None
        if track_order:
            base = 1 + len(stat_keys)
            globally_sorted = bool(gathered[:, base].all())
            prev_last = None
            for row in gathered if globally_sorted else ():
                if not row[base + 1]:
                    continue  # the rank wrote nothing
                r_first = tuple(int(v) for v in row[base + 2:base + 5])
                if prev_last is not None and r_first < prev_last:
                    globally_sorted = False
                    break
                prev_last = tuple(int(v) for v in row[base + 5:base + 8])

        my_offset = int(gathered[: process_index(), 0].sum())
        _create_output(out_path, out_header, total_kept)
        pos_out = HEADER_SIZE + RECORD_SIZE * my_offset
        try:
            fd = os.open(out_path, os.O_WRONLY)
            try:
                if spool_file is not None:
                    spool_file.seek(0)
                    while chunk := spool_file.read(1 << 23):
                        _pwrite_all(fd, chunk, pos_out)
                        pos_out += len(chunk)
                else:
                    for out, _ in out_batches():
                        data = np.ascontiguousarray(out).view(np.uint8)
                        _pwrite_all(fd, data, pos_out)
                        pos_out += data.nbytes
            finally:
                os.close(fd)
        except BaseException as e:
            failed = e
        _finish_write(failed, "the write pass", out_path)
    finally:
        if spool_file is not None:
            spool_file.close()
    return total_kept, totals, globally_sorted


def multihost_filter_file(
    in_path: str,
    out_path: str,
    barcodes,
    invert: bool = False,
    batch_records: int = 4 * 1024 * 1024,
) -> dict:
    """Cohort-wide allowlist filtering: :func:`ibu_tpu_torch.pipelines.filter_file`
    with every rank streaming only its record range (the shared-filesystem
    contract of :func:`multihost_sort_file`). Host numpy: no card is used.
    Record order, and so the input's sorted flag, survives because the
    ranges are contiguous and in rank order. The output is byte-identical to
    the single-process tool's.
    """
    from ibu_tpu_torch.pipelines import _require_plain, allowlist_mask, filter_file

    if process_count() == 1:
        return filter_file(
            in_path, out_path, barcodes, invert=invert, batch_records=batch_records,
        )

    _require_plain(in_path, "filter_file")
    allow = np.unique(np.asarray(list(barcodes), dtype=np.uint64))
    reader = MmapReader(in_path)
    header = reader.header()
    out_header = Header.new(header.bc_len, header.umi_len)
    out_header.flags = header.flags  # the sorted flag survives

    def transform(batch):
        return batch[allowlist_mask(batch["barcode"], allow, invert)], {}

    kept, _, _ = _multihost_rewrite(reader, out_path, out_header, transform, batch_records)
    return {"records": reader.len(), "kept": kept, "allowlist": int(len(allow))}


def multihost_correct_file(
    in_path: str,
    out_path: str,
    barcodes,
    batch_records: int = 4 * 1024 * 1024,
    keep_unmatched: bool = False,
    device: str | torch.device | None = None,
) -> dict:
    """Cohort-wide Hamming-1 barcode correction:
    :func:`ibu_tpu_torch.pipelines.correct_file` with every rank streaming
    only its record range and probing on its own card (``device``). The
    output's sorted flag follows the single-process observed-order rule,
    verified ACROSS ranks (local verification and the boundary pairs of the
    count gather); rank 0 patches the flag after the write checkpoint, and a
    last checkpoint makes every rank return after the patch. The output
    bytes match the single-process tool's.
    """
    from ibu_tpu_torch.ops.correct import CORRECTED, DROP, EXACT, correct_batch
    from ibu_tpu_torch.pipelines import _require_plain, correct_file

    if process_count() == 1:
        return correct_file(
            in_path, out_path, barcodes, batch_records=batch_records,
            keep_unmatched=keep_unmatched, device=device,
        )

    allow = np.unique(np.asarray(list(barcodes), dtype=np.uint64))
    _require_plain(in_path, "correct_file")
    failed: BaseException | None = None
    try:
        device = resolve_device(device)
    except BaseException as e:
        failed = e
    _cohort_checkpoint(failed, "the device lookup")
    reader = MmapReader(in_path)
    header = reader.header()
    out_header = Header.new(header.bc_len, header.umi_len)

    def transform(batch):
        batch = batch.copy()
        fixed, status = correct_batch(batch["barcode"], allow, header.bc_len, device=device)
        batch["barcode"] = fixed
        keep = np.ones(len(batch), dtype=bool) if keep_unmatched else status != DROP
        return batch[keep], {
            "exact": int(np.count_nonzero(status == EXACT)),
            "corrected": int(np.count_nonzero(status == CORRECTED)),
            "dropped": int(np.count_nonzero(status == DROP)),
        }

    kept, totals, globally_sorted = _multihost_rewrite(
        reader, out_path, out_header, transform, batch_records,
        stat_keys=("exact", "corrected", "dropped"), track_order=True,
        spool=True,  # the Hamming probe dominates: run it once
    )
    try:
        if globally_sorted and kept > 0 and process_index() == 0:
            out_header.set_sorted()
            with open(out_path, "r+b") as f:
                f.seek(16)
                f.write(struct.pack("<Q", out_header.flags))
    except BaseException as e:
        failed = e
    # every rank returns after the patch, or raises with the output gone
    _finish_write(failed, "the sorted-flag patch", out_path)
    return {
        "records": reader.len(),
        "exact": totals["exact"],
        "corrected": totals["corrected"],
        "dropped": totals["dropped"],
        "allowlist": int(len(allow)),
    }


#: barcode samples contributed per rank to the splitter election
_COUNT_SPLIT_SAMPLES = 512


def multihost_count_matrix(
    in_path: str,
    out_prefix: str,
    batch_records: int = 4 * 1024 * 1024,
    dedup: bool = True,
) -> dict:
    """Cohort-wide barcode × index count matrix:
    :func:`ibu_tpu_torch.pipelines.count_matrix` (host engine) with both heavy
    stages, the per-batch uniquing and the global merge, format and write,
    sharded across ranks; no stage is O(answer) on one rank. Host numpy: no
    card is used.

    1. **range partial**: every rank streams only its record range
       (:func:`ibu_tpu_torch.pipelines._count_range_partial`; sorted inputs
       keep the O(n) adjacent difference with a boundary carry).
    2. **splitters**: each rank gathers evenly spaced samples of its
       partial's nondecreasing barcode column (compared as unsigned words);
       rank *d* owns barcodes ``[sp[d-1], sp[d])``, so a barcode belongs
       wholly to one rank.
    3. **exchange** through ``{out_prefix}.mh_count.part{rank}.npz`` on the
       shared filesystem: each destination's rows are ONE contiguous slice
       of the partial (``searchsorted``); the file also carries the rank's
       sorted unique indices.
    4. **range merge**: rank *d* merges only its barcode range
       (:func:`ibu_tpu_torch.pipelines._count_pairs_from_partials`); the
       global index array is the union of every rank's, the same on all.
    5. **cooperative output**: the entries are globally row-major by
       construction, so each rank formats its own ``.mtx`` entry block,
       ``barcodes.txt`` block (``bc_len+1`` bytes a line) and
       ``indices.txt`` slice, and ``pwrite``s them at offsets from one
       gather of block sizes. The trio is byte-identical to the
       single-process host engine's.

    Every local failure travels through a checkpoint, so all ranks fail
    together; a failed cooperative write unlinks all three outputs on every
    rank, and the part file is unlinked on every way out.
    """
    from ibu_tpu_torch.ops import codec as C
    from ibu_tpu_torch.pipelines import (
        _count_pairs_from_partials,
        _count_range_partial,
        _format_mtx_entries,
        _require_plain,
        count_matrix,
    )

    if process_count() == 1:
        return count_matrix(
            in_path, out_prefix, batch_records=batch_records, dedup=dedup, engine="host",
        )

    _require_plain(in_path, "count_matrix")
    reader = MmapReader(in_path)
    header = reader.header()
    n = reader.len()
    start, end = local_record_range(n)
    pid = process_index()
    nprocs = process_count()

    failed: BaseException | None = None
    part_path = f"{out_prefix}.mh_count.part{pid}.npz"
    out_paths = (f"{out_prefix}.mtx", f"{out_prefix}.barcodes.txt", f"{out_prefix}.indices.txt")
    try:
        # -- stage 1: range partial (kept in memory for the later slices) --
        keys = weights = None
        try:
            keys, weights = _count_range_partial(
                reader, start, end, dedup, batch_records, in_path, boundary_carry=True,
            )
        except BaseException as e:
            failed = e
        _cohort_checkpoint(failed, "the range-partial pass")

        # -- stage 2: splitter election over the unsigned barcode samples;
        # an empty partial contributes the all-ones word, which sorts last --
        s_n = _COUNT_SPLIT_SAMPLES
        bc_col = keys["barcode"]
        if len(bc_col):
            samples = bc_col[_even_sample_positions(len(bc_col), s_n)]
        else:
            samples = np.full(s_n, np.uint64(0xFFFFFFFFFFFFFFFF), dtype=np.uint64)
        gathered = np.sort(
            _allgather_host(samples.astype(np.uint64).view(np.int64)).view(np.uint64).reshape(-1)
        )
        splitters = gathered[_splitter_cut_indices(len(gathered), nprocs)]
        # rank d owns the barcodes b with (number of splitters <= b) == d

        # -- stage 3: exchange write (per-destination contiguous slices) --
        try:
            cuts = np.concatenate(
                [[0], np.searchsorted(bc_col, splitters, side="right"), [len(keys)]]
            )
            payload = {"idx": np.unique(keys["index"])}
            for d in range(nprocs):
                payload[f"k{d}"] = keys[cuts[d]:cuts[d + 1]]
                if weights is not None:
                    payload[f"w{d}"] = weights[cuts[d]:cuts[d + 1]]
            np.savez(part_path, **payload)
        except BaseException as e:
            failed = e
        _cohort_checkpoint(failed, "the exchange write")

        # -- stage 4: merge MY barcode range and the (identical) index union --
        pairs = counts = indices = bc_u = None
        try:
            key_parts, weight_parts, idx_parts = [], [], []
            for r in range(nprocs):
                with np.load(f"{out_prefix}.mh_count.part{r}.npz") as z:
                    key_parts.append(z[f"k{pid}"])
                    if f"w{pid}" in z:
                        weight_parts.append(z[f"w{pid}"])
                    idx_parts.append(z["idx"])
            indices = np.unique(np.concatenate(idx_parts))
            pairs, counts = _count_pairs_from_partials(
                key_parts, weight_parts, dedup=dedup,
                presorted=dedup and header.sorted(),  # carried ranges
            )
            bc_u = np.unique(pairs["barcode"])
        except BaseException as e:
            failed = e
        gathered = _cohort_checkpoint(
            failed, "the range merge",
            (0, 0, 0) if failed is not None else (len(bc_u), len(pairs), int(counts.sum())),
        )
        r_total = int(gathered[:, 0].sum())
        nnz = int(gathered[:, 1].sum())
        molecules = int(gathered[:, 2].sum())
        prefix_bc = int(gathered[:pid, 0].sum())

        # -- stage 5: format my blocks; offsets from one size gather --
        mtx_block = bc_block = idx_block = b""
        try:
            if len(pairs):
                row = prefix_bc + np.searchsorted(bc_u, pairs["barcode"])
                col = np.searchsorted(indices, pairs["index"])
                mtx_block = _format_mtx_entries(row + 1, col + 1, np.asarray(counts)).encode()
            bc_block = "".join(s + "\n" for s in C.decode_seqs(bc_u, header.bc_len)).encode()
            i_lo, i_hi = partition(len(indices), nprocs)[pid]
            idx_block = "".join(f"{int(i)}\n" for i in indices[i_lo:i_hi]).encode()
        except BaseException as e:
            failed = e
        gathered = _cohort_checkpoint(
            failed, "the block formatting", (len(mtx_block), len(idx_block))
        )
        mtx_head = (
            "%%MatrixMarket matrix coordinate integer general\n"
            "%rows=barcodes cols=record-indices "
            f"source={in_path} dedup={dedup}\n"
            f"{r_total} {len(indices)} {nnz}\n"
        ).encode()
        mtx_off = len(mtx_head) + int(gathered[:pid, 0].sum())
        mtx_size = len(mtx_head) + int(gathered[:, 0].sum())
        bc_off = prefix_bc * (header.bc_len + 1)
        bc_size = r_total * (header.bc_len + 1)
        idx_off = int(gathered[:pid, 1].sum())
        idx_size = int(gathered[:, 1].sum())

        try:
            if pid == 0:
                with open(out_paths[0], "wb") as f:
                    f.write(mtx_head)
                    f.truncate(mtx_size)
                with open(out_paths[1], "wb") as f:
                    f.truncate(bc_size)
                with open(out_paths[2], "wb") as f:
                    f.truncate(idx_size)
        except BaseException as e:
            failed = e
        try:
            _cohort_checkpoint(failed, "output creation")
            for path, block, off in (
                (out_paths[0], mtx_block, mtx_off),
                (out_paths[1], bc_block, bc_off),
                (out_paths[2], idx_block, idx_off),
            ):
                if not block:
                    continue
                fd = os.open(path, os.O_WRONLY)
                try:
                    _pwrite_all(fd, block, off)
                finally:
                    os.close(fd)
        except BaseException as e:
            failed = e
        # a partial cooperative write must not survive as a valid-looking trio
        _finish_write(failed, "the write pass", *out_paths)

        return {
            "barcodes": r_total,
            "indices": int(len(indices)),
            "entries": nnz,
            "molecules": molecules,
            "records": n,
        }
    finally:
        try:
            os.unlink(part_path)
        except OSError:
            pass


def multihost_ingest_fastq(
    fastq_path: str,
    ibu_path: str,
    bc_len: int,
    umi_len: int,
    batch: int = 200_000,
    validate: bool = True,
    device: str | torch.device | None = None,
) -> int:
    """Cohort-wide FASTQ → sorted IBU: the whole ingest sharded over the
    ranks.

    A plain FASTQ splits EXACTLY across ranks without parsing it twice:

    * raw byte ranges partition by the reference rule; each rank counts the
      newlines in its range (one vectorized memmap scan) and one gather
      gives every rank the global line index at its range start, so the
      every-4th-line phase, the 1-based line numbers in errors and each
      rank's global READ index base follow by arithmetic;
    * range starts align forward to the next line start (a line whose first
      byte lies in a range belongs to that rank and is consumed to its real
      end, the byte-range contract of
      :func:`ibu_tpu_torch.pipelines.fastq_prefix_batches`);
    * each rank parses and encodes only its reads (the codec on ``device``
      when the device engine is chosen, once per rank) and ``pwrite``s them
      at its exact offset of ``ibu_path + ".mhingest.tmp"``, then
      :func:`multihost_sort_file` writes the sorted output.

    Failures are cohort-uniform (checkpoints). Gzip/zstd FASTQs have no
    random access: ingest those in one process. Returns the cohort's read
    count on every rank.
    """
    from ibu_tpu_torch.io.compression import infer_compression, sniff_compression
    from ibu_tpu_torch.io.stream import thread_prefetched
    from ibu_tpu_torch.ops import codec as C
    from ibu_tpu_torch.pipelines import (
        _codec_engine,
        encode_batch,
        fastq_prefix_batches,
        ingest_fastq,
    )

    if process_count() == 1:
        return ingest_fastq(
            fastq_path, ibu_path, bc_len, umi_len, batch=batch, validate=validate,
            device=device,
        )

    with open(fastq_path, "rb") as f:
        kind = sniff_compression(f.read(4))
    if kind is not None:
        raise ValueError(
            f"{fastq_path} is {kind}-compressed: no random access to "
            "shard it across hosts — decompress first, or ingest "
            "single-host (compressed ingest streams fine there)"
        )
    if infer_compression(ibu_path):
        raise ValueError(
            "compressed output cannot be pwritten cooperatively; use a "
            "plain .ibu output (compress it afterwards if needed)"
        )

    nprocs = process_count()
    pid = process_index()
    prefix_len = bc_len + umi_len
    size = os.path.getsize(fastq_path)
    bounds = partition(size, nprocs)
    lo, hi = bounds[pid]
    step = 1 << 26

    # the codec engine (and its card) once per rank; the newlines in my raw
    # range and my aligned start (the first line start >= lo)
    failed: BaseException | None = None
    nl_mine, aligned = 0, lo
    try:
        engine = _codec_engine("auto", device)
        if engine == "device":
            device = resolve_device(device)
        # mode="r": shared inputs often sit on read-only mounts
        mm = np.memmap(fastq_path, np.uint8, mode="r") if size else None
        for p in range(lo, hi, step):
            nl_mine += int(np.count_nonzero(mm[p:min(p + step, hi)] == 10))
        if lo > 0 and mm[lo - 1] != 10:
            aligned = size  # no line starts at or after lo unless a \n is found
            for p in range(lo, size, step):
                hits = np.flatnonzero(mm[p:min(p + step, size)] == 10)
                if len(hits):
                    aligned = p + int(hits[0]) + 1
                    break
    except BaseException as e:
        failed = e
    gathered = _cohort_checkpoint(failed, "the newline count", (nl_mine, aligned))
    total_lines = int(gathered[:, 0].sum()) + (1 if size and mm[size - 1] != 10 else 0)
    # the global line index at every rank's aligned start, by the same rule
    line_starts = [
        int(gathered[:r, 0].sum()) + (1 if gathered[r, 1] > bounds[r][0] else 0)
        for r in range(nprocs)
    ] + [total_lines]

    def seq_lines_below(x: int) -> int:  # lines with index % 4 == 1
        return (x + 2) // 4

    reads = [seq_lines_below(line_starts[r + 1]) - seq_lines_below(line_starts[r])
             for r in range(nprocs)]
    total = int(sum(reads))
    base = int(sum(reads[:pid]))

    tmp = ibu_path + ".mhingest.tmp"
    try:
        _create_output(tmp, Header.new(bc_len, umi_len), total)
        written = 0
        try:
            fd = os.open(tmp, os.O_WRONLY)
            try:
                pos_out = HEADER_SIZE + RECORD_SIZE * base
                # parse ahead on a thread, as the single-process ingest does
                for prefixes in thread_prefetched(
                    fastq_prefix_batches(
                        fastq_path, prefix_len, batch,
                        byte_range=(aligned, hi), line_base=line_starts[pid],
                    ),
                    depth=2,
                ):
                    if validate:
                        C.np_validate_ascii(prefixes)
                    idx = np.arange(base + written, base + written + len(prefixes),
                                    dtype=np.uint64)
                    records = encode_batch(
                        prefixes[:, :bc_len], prefixes[:, bc_len:], idx,
                        engine=engine, device=device,
                    )
                    data = np.ascontiguousarray(records).view(np.uint8)
                    _pwrite_all(fd, data, pos_out)
                    pos_out += data.nbytes
                    written += len(prefixes)
            finally:
                os.close(fd)
            if written != reads[pid]:  # the parse against the line arithmetic
                raise AssertionError(
                    f"rank {pid} parsed {written} reads, expected "
                    f"{reads[pid]} from the line arithmetic"
                )
        except BaseException as e:
            failed = e
        _cohort_checkpoint(failed, "the parse/encode pass")

        # an existing ibu_path is replaced only by the sort, which removes its
        # own partial writes: a parse error leaves an older file alone
        multihost_sort_file(tmp, ibu_path, device=device)
        return total
    finally:
        if pid == 0:
            try:
                os.unlink(tmp)
            except OSError:
                pass


def multihost_export_fastq(
    ibu_path: str,
    fastq_path: str,
    batch_records: int = 1 << 20,
    qual: str = "I",
    device: str | torch.device | None = None,
) -> tuple[int, int, str]:
    """Cohort-wide FASTQ export: every rank decodes only its record range
    (on ``device`` when the device codec is chosen) into its own shard file
    (``reads.fastq.gz`` → ``reads.part3.fastq.gz`` on rank 3: per-host
    shards are the usual FASTQ convention, and compressed streams cannot be
    pwritten cooperatively anyway).

    Read names carry the record index, so the shards concatenated in rank
    order are the single-process export exactly. Returns ``(total_reads,
    local_reads, this_rank_shard_path)``; the total is gathered, so every
    rank knows the cohort's count beside its own. A failure on any rank
    raises on every rank, and each rank removes its shard.
    """
    from ibu_tpu_torch.pipelines import _require_plain, export_fastq

    if process_count() == 1:
        mine = export_fastq(
            ibu_path, fastq_path, batch_records=batch_records, qual=qual, device=device
        )
        return mine, mine, fastq_path

    _require_plain(ibu_path, "export-fastq --distributed")
    reader = MmapReader(ibu_path)
    start, end = local_record_range(reader.len())

    d, base = os.path.split(fastq_path)
    dot = base.find(".")
    pid = process_index()
    shard = f"{base}.part{pid}" if dot < 0 else f"{base[:dot]}.part{pid}{base[dot:]}"
    shard_path = os.path.join(d, shard)

    failed: BaseException | None = None
    mine = 0
    try:
        mine = export_fastq(
            ibu_path, shard_path, batch_records=batch_records, qual=qual,
            record_range=(start, end), device=device,
        )
    except BaseException as e:
        failed = e
    total = int(_finish_write(failed, "the export", shard_path, extra=(mine,)).sum())
    return total, mine, shard_path
