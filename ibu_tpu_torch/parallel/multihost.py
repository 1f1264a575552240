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

A process that never joined a group is a world of size 1, and every engine
then takes its single-process path, as the JAX package's do when
``jax.process_count() == 1``. ``process_local_placer`` and
``local_soa_batches`` have no counterpart: each rank places its own block on
its own card, and the ``(6, N)`` column layout is the TPU's.
"""

from __future__ import annotations

import os
import socket
import sys
from typing import Iterator

import numpy as np
import torch
import torch.distributed as dist

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
    (``spill``). Sorted files take the no-sort fast path: the flag is read
    from the same header bytes on every rank and verified on the card.
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
    from ibu_tpu_torch.constructs.header import Header

    out = Header.new(header.bc_len, header.umi_len)
    out.flags = header.flags
    out.set_sorted()
    return out


def _create_output(out_path: str, header, n: int) -> None:
    """Rank 0 pre-creates the full-size output behind a checkpoint, so a
    quota or permission error fails every rank together."""
    from ibu_tpu_torch.constructs.header import HEADER_SIZE
    from ibu_tpu_torch.constructs.record import RECORD_SIZE

    failed = None
    try:
        if process_index() == 0:
            with open(out_path, "wb") as f:
                f.write(header.as_bytes())
                f.truncate(HEADER_SIZE + RECORD_SIZE * n)
    except BaseException as e:
        failed = e
    _cohort_checkpoint(failed, "output creation")


def _finish_write(failed: BaseException | None, stage: str, out_path: str) -> None:
    """The last checkpoint of a cooperative write: a failure on any rank
    unlinks the output, so no full-size sorted-flagged file with zero
    records in its dead ranges survives."""
    try:
        _cohort_checkpoint(failed, stage)
    except BaseException:
        try:
            os.unlink(out_path)
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
    from ibu_tpu_torch.constructs.header import HEADER_SIZE
    from ibu_tpu_torch.constructs.record import RECORD_DTYPE, RECORD_SIZE
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
    from ibu_tpu_torch.constructs.header import HEADER_SIZE
    from ibu_tpu_torch.constructs.record import RECORD_SIZE
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
