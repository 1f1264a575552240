"""Record sort over the cards of a cohort (sample sort).

Counterpart of :mod:`ibu_tpu.parallel.sort`. The JAX package runs one
``shard_map`` program over its device mesh; here shard ``g`` is rank ``g`` of
the ``torch.distributed`` cohort (:mod:`ibu_tpu_torch.parallel.multihost`),
one card per rank, and the steps are the same:

1. **stride deal**: rank ``g`` takes record positions ``g, g+S, …``, so
   every rank holds a uniform positional sample of the key range whatever the
   input order (a contiguous split of a sorted file would send each rank's
   whole block to one destination);
2. **local sort** on the card with the header hints
   (:func:`ibu_tpu_torch.ops.stats.sort_records`: provably-zero hi words
   dropped from the keys);
3. **splitters**: each rank takes ``samples_per_shard`` keys at the JAX
   package's positions, each with its **position word** in the sorted block
   as the last key, so a hot key (the dedup workload) spreads over ranks by
   position instead of flooding one; the gathered samples are sorted and
   ``S-1`` splitters taken at ``(d+1)·q``;
4. **partition**: the block is sorted, so each destination's records are one
   contiguous range, found by comparing with the splitters;
5. **exchange**: the per-destination counts are gathered first, then one
   ``all_to_all_single`` with those split sizes moves exactly the records
   (over NCCL where every rank has a card of its own, else over Gloo through
   pinned host buffers);
6. **merge**: each rank sorts what it received and holds a globally ordered
   contiguous run (rank ``d`` holds keys ``(splitter_{d-1}, splitter_d]``).

The exchange capacity of the JAX package is kept as a rule: a send range
over ``c_send = min(max(64, cdiv(local_n, S)·slack), local_n)`` records
(``local_n`` the :func:`_shape_bucket` of the rank width) raises the
reference's overflow error on every rank, so the same input at the same
``S`` fails the same way. The power-of-two padding of its sorts (a TPU
workaround) is dropped; u64 order is int64 order after
:func:`~ibu_tpu_torch.ops.u64.flip_sign`. An empty rank samples the all-max
sentinel, as there, so it sorts last.

Outside a cohort ``S`` is 1 and the sort is the local sort. In a cohort of
one rank (a group of size 1) the collectives still run.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ibu_tpu_torch.constructs.record import RECORD_DTYPE
from ibu_tpu_torch.ops.stats import sort_records
from ibu_tpu_torch.ops.u64 import (
    flip_sign,
    records_from_tensor,
    records_to_tensor,
    to_host,
    to_signed,
)
from ibu_tpu_torch.parallel import multihost as MH
from ibu_tpu_torch.utils.device import resolve_device

_LO32 = 0xFFFFFFFF
_U64_MAX = (1 << 64) - 1


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _shape_bucket(n: int) -> int:
    """Round a shard width up to the next ``{2^k, 1.5*2^k}`` bucket (the JAX
    package's compile-cache bucket; here it sizes the exchange capacity
    rule only, so the same input overflows at the same ``slack``)."""
    if n <= 64:
        return 64
    k = (n - 1).bit_length()  # 2^(k-1) < n <= 2^k
    mid = (1 << (k - 1)) + (1 << (k - 2))
    return mid if n <= mid else 1 << k


def _hi_used(bc_len, umi_len, index_bits) -> tuple[bool, bool, bool]:
    return (
        bc_len is None or bc_len > 16,
        umi_len is None or umi_len > 16,
        index_bits is None or index_bits > 32,
    )


def _verify_hints_host(records: np.ndarray, hi_used) -> None:
    names = ["barcode", "umi", "index"]
    bad = []
    for f in range(3):
        if not hi_used[f]:
            col = records[names[f]]
            if len(col) and int(col.max()) > 0xFFFFFFFF:
                bad.append(names[f])
    if bad:
        raise ValueError(
            f"sort hint violated: {', '.join(bad)} hi word(s) contain "
            "nonzero bits; fix the bc_len/umi_len/index_bits hints"
        )


def _local_sort(block: torch.Tensor, hi_used) -> torch.Tensor:
    """The hinted sort of :func:`~ibu_tpu_torch.ops.stats.sort_records`,
    hints trusted (they were verified on the host): dropped hi words come
    back as zeros, the JAX program's reconstruction."""
    return sort_records(
        block,
        bc_len=None if hi_used[0] else 16,
        umi_len=None if hi_used[1] else 16,
        index_bits=None if hi_used[2] else 32,
        check=False,
    )


def _samples(srt: torch.Tensor, local_n: int, q: int, hi_used) -> np.ndarray:
    """``(q, 4)`` uint64 samples ``[barcode, umi, index, position]`` of a
    sorted block at the JAX program's positions ``(2k+1)·n_valid // 2q``
    (clipped into its power-of-two width); an empty block samples the
    sentinel, all-max in every retained key word."""
    n_valid = srt.shape[0]
    m = 2 * q
    k_odd = 2 * np.arange(q, dtype=np.int64) + 1
    npad = 1 << max(0, (local_n - 1).bit_length())
    at = np.clip(k_odd * (n_valid // m) + (k_odd * (n_valid % m)) // m, 0, npad - 1)
    if n_valid:
        rows = to_host(srt[torch.from_numpy(at).to(srt.device)]).view(np.uint64)
    else:
        sentinel = [_U64_MAX if used else _LO32 for used in hi_used]
        rows = np.tile(np.array(sentinel, dtype=np.uint64), (q, 1))
    return np.column_stack([rows, at.astype(np.uint64)])


def _splitters(gathered: np.ndarray, s: int, q: int) -> np.ndarray:
    """``(s-1, 4)`` uint64 splitters: the gathered samples sorted on all four
    words, taken at ``(d+1)·q``."""
    order = np.lexsort(gathered.T[::-1])
    return gathered[order][(np.arange(s - 1) + 1) * q]


def _dest_counts(srt: torch.Tensor, splitters: np.ndarray) -> np.ndarray:
    """Records of the sorted block bound for each rank: destination ``t``
    takes the rows whose ``(key, position)`` lies in ``(splitter_{t-1},
    splitter_t]``, one contiguous range since the block is sorted."""
    n = srt.shape[0]
    cols = [flip_sign(srt[:, f]) for f in range(3)]
    cols.append(torch.arange(n, dtype=torch.int64, device=srt.device))
    bounds = []
    for sp in splitters:
        words = [to_signed(int(w) ^ (1 << 63)) for w in sp[:3]] + [int(sp[3])]
        lt = torch.zeros(n, dtype=torch.bool, device=srt.device)
        eq = torch.ones(n, dtype=torch.bool, device=srt.device)
        for c, w in zip(cols, words):
            lt |= eq & (c < w)
            eq &= c == w
        bounds.append(lt | eq)
    if not bounds:
        return np.array([n], dtype=np.int64)
    ends = torch.stack(bounds).sum(dim=1).tolist() + [n]
    return np.diff(np.array([0] + ends, dtype=np.int64))


def _exchange(srt: torch.Tensor, matrix: np.ndarray, me: int) -> torch.Tensor:
    """Send ``matrix[me, t]`` rows of the sorted block to each rank ``t``;
    receive ``matrix[r, me]`` rows from each rank ``r`` (one
    ``all_to_all_single`` with exact split sizes)."""
    send = matrix[me].tolist()
    recv = matrix[:, me].tolist()
    groups = MH._groups()
    device = srt.device
    if MH.exchange_backend(device) == "nccl":
        out = torch.empty((sum(recv), 3), dtype=torch.int64, device=device)
        dist.all_to_all_single(out, srt, recv, send, group=groups["nccl"])
        return out
    cuda = device.type == "cuda"
    host_in = srt
    if cuda:
        host_in = torch.empty(srt.shape, dtype=torch.int64, pin_memory=True)
        host_in.copy_(srt)
    host_out = torch.empty((sum(recv), 3), dtype=torch.int64, pin_memory=cuda)
    dist.all_to_all_single(host_out, host_in, recv, send, group=groups["gloo"])
    return host_out.to(device, non_blocking=True) if cuda else host_out


def _sample_sort(load, total: int, hi_used, slack: float, samples_per_shard: int,
                 check_records: np.ndarray | None = None):
    """This rank's part of the sample sort: ``(run, matrix)``, the rank's
    sorted run on its card and the ``(S, S)`` count matrix (``matrix[r, t]``
    records went from rank ``r`` to rank ``t``).

    ``load()`` gives this rank's dealt block on its card; ``total`` is the
    record count over all ranks; ``check_records``, where given, is verified
    against the hints first. Every step that can fail locally reports
    through a cohort checkpoint, so a failure raises on every rank.
    """
    s, me = MH.process_count(), MH.process_index()
    cohort = dist.is_initialized()
    local_n = _shape_bucket(_cdiv(max(total, 1), s))
    c_send = min(max(64, int(_cdiv(local_n, s) * slack)), local_n)
    q = samples_per_shard

    failed = None
    samples = np.zeros((q, 4), dtype=np.uint64)
    try:
        if check_records is not None and not all(hi_used):
            _verify_hints_host(check_records, hi_used)
        srt = _local_sort(load(), hi_used)
        if cohort:
            samples = _samples(srt, local_n, q, hi_used)
    except BaseException as e:
        if not cohort:
            raise
        failed = e
    if not cohort:
        return srt, np.array([[srt.shape[0]]], dtype=np.int64)
    gathered = MH._cohort_checkpoint(failed, "the local sort", samples)
    splitters = _splitters(gathered.view(np.uint64).reshape(s * q, 4), s, q)

    counts = np.zeros(s, dtype=np.int64)
    try:
        counts = _dest_counts(srt, splitters)
    except BaseException as e:
        failed = e
    matrix = MH._cohort_checkpoint(failed, "the partition", counts)
    if (matrix > c_send).any():
        raise ValueError(
            "sharded sort exchange overflow: a shard's range exceeded "
            f"c_send={c_send} (slack={slack}); retry with a larger slack"
        )
    run = _exchange(srt, matrix, me)
    del srt
    try:
        run = _local_sort(run, hi_used)
    except BaseException as e:
        failed = e
    MH._cohort_checkpoint(failed, "the merge")
    return run, matrix


def sharded_sort_records(
    records: np.ndarray,
    device: str | torch.device | None = None,
    bc_len: int | None = None,
    umi_len: int | None = None,
    index_bits: int | None = None,
    check: bool = True,
    slack: float = 2.0,
    samples_per_shard: int = 256,
) -> np.ndarray:
    """Lexicographic (barcode, umi, index) sort of a structured record
    array, distributed over the cohort's cards (sample sort, module
    docstring). In a cohort every rank passes the same ``records`` and gets
    the whole sorted array back.

    Hints follow :func:`ibu_tpu_torch.ops.stats.sort_records`: header base
    counts ≤16 / ``index_bits`` ≤32 drop provably-zero hi words from every
    key; ``check=True`` verifies them on the host (one pass over the hinted
    columns) and raises on violation instead of mis-sorting.

    Raises ``ValueError`` if a rank's send range overflows the
    ``slack``-sized exchange capacity (extremely skewed splitters; retry with
    a larger ``slack``).
    """
    device = resolve_device(device)
    records = np.asarray(records)
    hi_used = _hi_used(bc_len, umi_len, index_bits)
    s, me = MH.process_count(), MH.process_index()
    run, matrix = _sample_sort(
        lambda: records_to_tensor(np.ascontiguousarray(records[me::s]), device),
        len(records), hi_used, slack, samples_per_shard,
        check_records=records if check else None,
    )
    if s == 1:
        return records_from_tensor(run)
    parts = MH._allgather_varlen(to_host(run).T, matrix.sum(axis=0))
    wire = np.ascontiguousarray(np.concatenate([p.T for p in parts]))
    return wire.view(RECORD_DTYPE).reshape(-1)


def sort_file_mesh(
    in_path: str,
    out_path: str,
    device: str | torch.device | None = None,
    index_bits: int | None = None,
    slack: float = 2.0,
):
    """Sorted rewrite of an IBU file by the sample sort; returns the output
    header. In a cohort of more than one rank every rank reads only its dealt
    positions and writes its run into the shared output
    (:func:`ibu_tpu_torch.parallel.multihost._multihost_sort_mesh`). Header
    hints are host-verified exactly like the single-device path."""
    from ibu_tpu_torch.io.mmap import MmapReader
    from ibu_tpu_torch.io.writer import Writer
    from ibu_tpu_torch.pipelines import _require_plain

    _require_plain(in_path, "sort")
    reader = MmapReader(in_path)
    header = reader.header()
    out_header = MH._sorted_header(header)
    if MH.process_count() > 1:
        MH._multihost_sort_mesh(in_path, out_path, device=device,
                                index_bits=index_bits, slack=slack)
        return out_header
    records = np.asarray(reader.records)
    if index_bits is None:
        idx_hi = records["index"] >> np.uint64(32)
        index_bits = 32 if not idx_hi.any() else None
    sorted_records = sharded_sort_records(
        records,
        device=device,
        bc_len=header.bc_len,
        umi_len=header.umi_len,
        index_bits=index_bits,
        slack=slack,
    )
    with Writer.from_path(out_path, out_header) as w:
        w.write_batch(sorted_records)
    return out_header
