"""Command-line interface: ``python -m ibu_tpu_torch <command>``.

The day-to-day file operations as subcommands, the same 19 as ``python -m
ibu_tpu`` with the same options, printed lines and exit codes:

    python -m ibu_tpu_torch info data.ibu            # header + record count
    python -m ibu_tpu_torch stats data.ibu           # count + field checksums
    python -m ibu_tpu_torch sort in.ibu out.ibu      # out-of-core sorted rewrite
    python -m ibu_tpu_torch merge out.ibu a.ibu b.ibu   # k-way sorted merge
    python -m ibu_tpu_torch split in.ibu shard{}.ibu 4  # reference-rule partition
    python -m ibu_tpu_torch histogram data.ibu       # per-barcode counts (top N)
    python -m ibu_tpu_torch decode data.ibu          # records → TSV (bc, umi, idx)
    python -m ibu_tpu_torch dedup in.ibu out.ibu     # one record per (bc, umi) pair
    python -m ibu_tpu_torch filter in.ibu out.ibu --barcodes cells.txt  # allowlist
    python -m ibu_tpu_torch correct in.ibu out.ibu --barcodes cells.txt # Hamming-1 fix
    python -m ibu_tpu_torch count in.ibu counts      # barcode x index matrix (.mtx)
    python -m ibu_tpu_torch ingest-fastq reads.fastq data.ibu     # FASTQ → sorted IBU
    python -m ibu_tpu_torch export-fastq data.ibu out.fastq.gz   # records → FASTQ
    python -m ibu_tpu_torch check data.ibu           # deep integrity audit
    python -m ibu_tpu_torch repair bad.ibu fixed.ibu # salvage intact records
    python -m ibu_tpu_torch concat out.ibu a.ibu b.ibu  # order-aware concatenation
    python -m ibu_tpu_torch subsample in.ibu out.ibu --fraction 0.1  # seeded downsample

``info``, ``check``, ``split``, ``merge``, ``filter``, ``lookup``,
``subsample``, ``repair``, ``concat`` and the native ``sort`` are host code
that loads no torch, so they start without its import. ``stats``, ``sort``,
``histogram``, ``decode``, ``cells``, ``count``, ``correct``, ``dedup``,
``ingest-fastq`` and ``export-fastq`` take ``--device``: the CUDA card by
default, or ``--device cpu`` for the plain torch versions on the CPU. The
port's functions look the device up only when the engine they run uses one;
without a card and without ``--device cpu`` they raise
:class:`~ibu_tpu_torch.errors.NoCardError` before they write anything, and the
command prints one line on stderr and exits 2: it never runs on the CPU
unasked. ``sort`` uses the native external merge
sort unless given ``--engine device``.

``stats``, ``histogram`` and ``sort --engine mesh|pod`` also run across a
``torch.distributed`` cohort, one rank per process and one card per rank
(:mod:`ibu_tpu_torch.parallel.multihost`): launch the same command as every
rank with ``--distributed`` and the work shards across the ranks::

    # 2 ranks (on host A, or on one host with two cards)
    python -m ibu_tpu_torch stats data.ibu --distributed \\
        --coordinator hostA:9876 --num-processes 2 --process-id 0  # rank 0
    python -m ibu_tpu_torch stats data.ibu --distributed \\
        --coordinator hostA:9876 --num-processes 2 --process-id 1  # rank 1

``--coordinator`` also takes any ``torch.distributed`` init URL
(``file:///shared/path``). Results print once (rank 0); ``sort`` writes the shared
output file cooperatively (every rank pwrites its own byte range). ``filter``,
``count``, ``correct``, ``dedup``, ``ingest-fastq`` and ``export-fastq`` do not
run across a cohort yet: the parser refuses ``--distributed`` and its three
flags there (exit code 2).
"""

from __future__ import annotations

import argparse
import json
import sys

from ibu_tpu_torch.errors import NO_CARD_HINT, IbuError, NoCardError


def _add_distributed_args(p) -> None:
    g = p.add_argument_group(
        "distributed",
        "run as one rank of a torch.distributed cohort (launch the same "
        "command as every rank; results print on rank 0)",
    )
    g.add_argument("--distributed", action="store_true",
                   help="join the cohort before running (pin it with the three "
                        "flags below)")
    g.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="rendezvous address (rank 0's host), or an init URL "
                        "such as file:///shared/path")
    g.add_argument("--num-processes", type=int, default=None)
    g.add_argument("--process-id", type=int, default=None)


def _maybe_init_distributed(args) -> None:
    """Join the cohort when ``--distributed`` was given (no-op when this
    process already is in one); callers print results on rank 0 only."""
    if args.distributed:
        from ibu_tpu_torch.parallel.multihost import init_distributed

        init_distributed(args.coordinator, args.num_processes, args.process_id)


def _is_rank0() -> bool:
    from ibu_tpu_torch.parallel.multihost import process_index

    return process_index() == 0


def _add_device_arg(p) -> None:
    p.add_argument("--device", default=None,
                   help="cuda, cuda:N or cpu (default: the current CUDA card)")


def _sniff(path: str) -> str | None:
    from ibu_tpu_torch.io.compression import sniff_compression

    with open(path, "rb") as f:
        return sniff_compression(f.read(4))


def _native_or_error():
    """The native module, or ``None`` after the reference's message."""
    from ibu_tpu_torch import native

    if not native.available():
        print(f"native runtime unavailable: {native.load_error()}", file=sys.stderr)
        return None
    return native


def cmd_info(args) -> int:
    kind = _sniff(args.path)
    if kind is None:
        from ibu_tpu_torch import MmapReader

        r = MmapReader(args.path)
        h, n = r.header(), r.len()
    else:
        # compressed: no random access, count by streaming the batches
        from ibu_tpu_torch import Reader

        with Reader.from_path(args.path) as rd:
            h = rd.header()
            n = sum(len(b) for b in rd.batches())
    print(json.dumps({
        "path": args.path,
        "magic": "IBU!",
        "version": h.version,
        "bc_len": h.bc_len,
        "umi_len": h.umi_len,
        "sorted": h.sorted(),
        "flags": h.flags,
        "records": n,
        "bytes": 32 + 24 * n,
        **({"compression": kind} if kind else {}),
    }))
    return 0


def cmd_stats(args) -> int:
    kind = _sniff(args.path)
    if args.distributed:
        if args.engine in ("native", "host"):
            print(f"--distributed shards over the cohort's cards; drop "
                  f"--engine {args.engine}", file=sys.stderr)
            return 2
        if kind is not None:
            print(f"{args.path} is {kind}-compressed; --distributed needs "
                  "per-host random access — decompress first",
                  file=sys.stderr)
            return 1
        _maybe_init_distributed(args)
        from ibu_tpu_torch.parallel.multihost import multihost_file_stats

        stats = multihost_file_stats(args.path, device=args.device)
        if _is_rank0():
            print(json.dumps(stats))
        return 0
    if kind is not None:
        if args.engine == "native":
            print(f"{args.path} is {kind}-compressed; the native engine "
                  "needs random access — decompress first or use the "
                  "default engine (streams compressed files)",
                  file=sys.stderr)
            return 1
        from ibu_tpu_torch import Reader

        if args.engine == "device":
            # forced device: stream decoded record batches through the same
            # map-reduce the mmap path uses
            from ibu_tpu_torch.parallel.device import STATS_MAP_REDUCE, finalize_stats

            stats = finalize_stats(
                STATS_MAP_REDUCE.run(Reader.from_path(args.path).batches(), args.device))
        else:
            # auto/host: a compressed stream is decompression-bound on the
            # host anyway, so sum the decoded batches there
            from ibu_tpu_torch.pipelines import host_stream_stats

            stats = host_stream_stats(Reader.from_path(args.path).batches())
    else:
        if args.engine == "native" and _native_or_error() is None:
            return 1
        from ibu_tpu_torch.pipelines import file_stats

        stats = file_stats(args.path, engine=args.engine, device=args.device)
        stats.pop("engine", None)  # identical JSON across engines
    print(json.dumps(stats))
    return 0


def cmd_sort(args) -> int:
    from ibu_tpu_torch.pipelines import _require_plain

    _require_plain(args.input, "sort")
    if args.distributed and args.engine not in ("mesh", "pod"):
        print("--distributed requires --engine mesh (the pod-wide device "
              "sample sort) or --engine pod (auto: mesh on CUDA cards, shared-FS "
              "native external sort elsewhere); native/device sorts are "
              "single-host", file=sys.stderr)
        return 2
    if args.engine in ("device", "mesh", "pod"):
        if (args.chunk_records or args.threads) and args.engine != "pod":
            print("--chunk-records/--threads only apply to --engine native "
                  "(the device sorts are in-memory)", file=sys.stderr)
            return 2
        if args.engine in ("mesh", "pod"):
            _maybe_init_distributed(args)
            from ibu_tpu_torch.parallel.multihost import multihost_sort_file

            multihost_sort_file(
                args.input, args.output, device=args.device,
                engine="mesh" if args.engine == "mesh" else "auto",
                chunk_records=args.chunk_records,
                nthreads=args.threads,
            )
            if not _is_rank0():
                return 0
        else:
            from ibu_tpu_torch.pipelines import sort_file_device

            sort_file_device(args.input, args.output, device=args.device)
        print(f"sorted {args.input} -> {args.output} ({args.engine})")
        return 0
    native = _native_or_error()
    if native is None:
        return 1
    native.sort_file(args.input, args.output,
                     chunk_records=args.chunk_records, nthreads=args.threads)
    print(f"sorted {args.input} -> {args.output}")
    return 0


def cmd_histogram(args) -> int:
    from ibu_tpu_torch import MmapReader

    kind = _sniff(args.path)
    if args.distributed:
        if args.engine == "host":
            print("--distributed shards over the cohort's cards; drop "
                  "--engine host", file=sys.stderr)
            return 2
        if kind is not None:
            print(f"{args.path} is {kind}-compressed; --distributed needs "
                  "per-host random access — decompress first",
                  file=sys.stderr)
            return 1
        _maybe_init_distributed(args)
        from ibu_tpu_torch.parallel.multihost import multihost_barcode_histogram

        hist = multihost_barcode_histogram(
            args.path,
            device=args.device,
            capacity=args.device_table or (1 << 20),
            max_uniques_per_shard=args.max_uniques,
        )
        if not _is_rank0():
            return 0
        hdr = MmapReader(args.path).header()
    else:
        if kind is None:
            from ibu_tpu_torch.parallel.device import record_batches_from_mmap

            reader = MmapReader(args.path)
            hdr = reader.header()
            batches = record_batches_from_mmap(reader)
        else:  # gzip/zstd: stream decoded batches into the same engines
            from ibu_tpu_torch import Reader

            r = Reader.from_path(args.path)
            hdr = r.header()
            batches = r.batches()
        engine = args.engine
        if engine == "host" and args.device_table:
            print("--device-table is a device-engine option; drop it or "
                  "use --engine device", file=sys.stderr)
            return 2
        if engine == "auto" and args.device_table:
            # an explicit device-table capacity chooses the device table
            # engine; no probe
            engine = "device"
        elif engine == "auto" and kind is not None:
            # a compressed stream is decompression-bound on the host anyway
            engine = "host"
        if engine == "auto":
            from ibu_tpu_torch.parallel.select import auto_device_or_host

            engine = auto_device_or_host(device=args.device)
        if engine == "host":
            from ibu_tpu_torch.pipelines import host_stream_histogram

            hist = host_stream_histogram(batches)
        elif args.device_table:
            from ibu_tpu_torch.parallel.device import DeviceHistogram

            # sorted inputs (header-claimed, checked on the device) skip the
            # per-batch sort
            hist = DeviceHistogram(
                capacity=args.device_table,
                max_uniques_per_shard=args.max_uniques,
                assume_sorted=hdr.sorted(),
                device=args.device,
            ).run(batches)
        else:
            from ibu_tpu_torch.parallel.device import sharded_barcode_histogram

            hist = sharded_barcode_histogram(
                batches, device=args.device, max_uniques_per_shard=args.max_uniques,
                sorted_in=hdr.sorted(),
            )
    import numpy as np

    from ibu_tpu_torch.ops import codec as C

    # ties break by ascending barcode so the listing is the same across
    # engines (auto may pick different ones for plain and compressed files)
    top = sorted(hist.items(), key=lambda kv: (-kv[1], kv[0]))[: args.top]
    for barcode, count in top:
        seq = C.decode_seqs(np.array([barcode], dtype=np.uint64), hdr.bc_len)[0]
        print(f"{seq}\t{count}")
    print(f"# {len(hist)} unique barcodes, {sum(hist.values())} records",
          file=sys.stderr)
    return 0


def cmd_decode(args) -> int:
    from ibu_tpu_torch import Reader
    from ibu_tpu_torch.pipelines import decode_batch, decode_tsv_block

    reader = Reader.from_path(args.path) if args.path != "-" else Reader.from_stdin()
    h = reader.header()
    out = sys.stdout.buffer
    emitted = 0
    for batch in reader.batches():
        if args.limit:
            batch = batch[: args.limit - emitted]
        # one decode and one vectorized TSV assembly per batch
        bc_rows, umi_rows, idx = decode_batch(batch, h.bc_len, h.umi_len, device=args.device)
        out.write(decode_tsv_block(bc_rows, umi_rows, idx))
        emitted += len(batch)
        if args.limit and emitted >= args.limit:
            break
    out.flush()
    return 0


def cmd_split(args) -> int:
    from ibu_tpu_torch.pipelines import split_file

    paths = split_file(args.input, args.template, args.shards)
    print(f"split {args.input} -> {len(paths)} shards "
          f"({paths[0]} .. {paths[-1]})")
    return 0


def cmd_merge(args) -> int:
    native = _native_or_error()
    if native is None:
        return 1
    native.merge_files(args.inputs, args.output)
    print(f"merged {len(args.inputs)} sorted files -> {args.output}")
    return 0


def _parse_barcode_list(path: str, bc_len: int):
    """Allowlist file → packed u64 barcodes. Each non-empty line is either
    an ACGT sequence of the file's barcode length (packed with the host
    codec) or an integer (decimal or 0x hex)."""
    import numpy as np

    from ibu_tpu_torch.ops.codec import np_pack, seqs_to_rows

    seqs, ints = [], []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            t = line.strip()
            if not t or t.startswith("#"):
                continue
            if set(t.upper()) <= set("ACGT"):
                if len(t) != bc_len:
                    raise SystemExit(
                        f"{path}:{lineno}: sequence {t!r} has length "
                        f"{len(t)}, file barcode length is {bc_len}"
                    )
                seqs.append(t.upper())
            else:
                try:
                    v = int(t, 0)
                except ValueError:
                    raise SystemExit(
                        f"{path}:{lineno}: {t!r} is neither an ACGT "
                        "sequence nor an integer"
                    )
                if not 0 <= v < 1 << 64:
                    raise SystemExit(
                        f"{path}:{lineno}: {t!r} is outside the u64 "
                        "barcode range"
                    )
                ints.append(v)
    out = [np.asarray(ints, dtype=np.uint64)]
    if seqs:
        out.append(np_pack(seqs_to_rows(seqs)))
    return np.concatenate(out)


def cmd_filter(args) -> int:
    from ibu_tpu_torch.io.mmap import MmapReader
    from ibu_tpu_torch.pipelines import _require_plain, filter_file

    _require_plain(args.input, "filter")  # before the bc_len mmap below
    bc_len = MmapReader(args.input).header().bc_len
    allow = _parse_barcode_list(args.barcodes, bc_len)
    stats = filter_file(args.input, args.output, allow, invert=args.invert)
    mode = "blocklist" if args.invert else "allowlist"
    print(
        f"filter {args.input} -> {args.output}: kept {stats['kept']} of "
        f"{stats['records']} records ({mode} of {stats['allowlist']} "
        "barcodes)"
    )
    return 0


def cmd_lookup(args) -> int:
    from ibu_tpu_torch.io.mmap import MmapReader
    from ibu_tpu_torch.ops import codec as C
    from ibu_tpu_torch.pipelines import _require_plain, lookup_barcodes

    _require_plain(args.path, "lookup")  # before the bc_len mmap below
    h = MmapReader(args.path).header()
    queries = []
    for q in args.barcode:
        if set(q.upper()) <= set("ACGT"):
            if len(q) != h.bc_len:
                raise SystemExit(
                    f"barcode {q!r} has length {len(q)}, file barcode "
                    f"length is {h.bc_len}"
                )
            queries.append(int(C.encode_seqs([q.upper()])[0]))
        else:
            queries.append(int(q, 0))
    hits = lookup_barcodes(args.path, queries)
    bc = C.decode_seqs(hits["barcode"], h.bc_len)
    umi = C.decode_seqs(hits["umi"], h.umi_len)
    for b, u, i in zip(bc, umi, hits["index"]):
        print(f"{b}\t{u}\t{int(i)}")
    print(f"# {len(hits)} records for {len(set(queries))} barcodes",
          file=sys.stderr)
    return 0


def cmd_cells(args) -> int:
    from ibu_tpu_torch.pipelines import call_cells

    stats = call_cells(
        args.input,
        args.output,
        method=args.method,
        expect=args.expect,
        min_count=args.min_count,
        engine=args.engine,
        device=args.device,
    )
    print(
        f"cells {args.input} -> {args.output}: {stats['cells']} cells of "
        f"{stats['barcodes']} barcodes ({stats['records']} records, "
        f"{stats['method']} threshold >= {stats['threshold']} reads)"
    )
    return 0


def cmd_count(args) -> int:
    from ibu_tpu_torch.pipelines import count_matrix

    stats = count_matrix(args.input, args.prefix, dedup=not args.raw_reads,
                         engine=args.engine, device=args.device)
    what = "reads" if args.raw_reads else "molecules"
    print(
        f"count {args.input} -> {args.prefix}.mtx: "
        f"{stats['barcodes']} barcodes x {stats['indices']} indices, "
        f"{stats['entries']} nonzero entries, {stats['molecules']} {what}"
    )
    return 0


def cmd_correct(args) -> int:
    from ibu_tpu_torch.io.mmap import MmapReader
    from ibu_tpu_torch.pipelines import _require_plain, correct_file

    _require_plain(args.input, "correct")  # before the bc_len mmap below
    bc_len = MmapReader(args.input).header().bc_len
    allow = _parse_barcode_list(args.barcodes, bc_len)
    stats = correct_file(args.input, args.output, allow,
                         keep_unmatched=args.keep_unmatched, device=args.device)
    print(
        f"correct {args.input} -> {args.output}: {stats['exact']} exact, "
        f"{stats['corrected']} corrected, {stats['dropped']} "
        f"{'unmatched kept' if args.keep_unmatched else 'dropped'} of "
        f"{stats['records']} records (allowlist of {stats['allowlist']})"
    )
    return 0


def cmd_dedup(args) -> int:
    from ibu_tpu_torch.pipelines import dedup_file

    assume = {"auto": None, "yes": True, "no": False}[args.assume_sorted]
    stats = dedup_file(args.input, args.output, assume_sorted=assume, device=args.device)
    print(
        f"dedup {args.input} -> {args.output}: {stats['records']} reads -> "
        f"{stats['molecules']} molecules across {stats['barcodes']} barcodes"
    )
    return 0


def cmd_check(args) -> int:
    from ibu_tpu_torch.pipelines import check_file

    report = check_file(args.path)
    if args.json:
        print(json.dumps(report))
    else:
        h = report["header"]
        if h is not None:
            print(
                f"{args.path}: bc_len={h['bc_len']} umi_len={h['umi_len']} "
                f"sorted={bool(h['flags'] & 1)} records={report['records']}"
            )
        for w in report["warnings"]:
            print(f"warning: {w}")
        for e in report["errors"]:
            print(f"error: {e}")
        print("OK" if report["ok"] else "CORRUPT")
    return 0 if report["ok"] else 1


def cmd_concat(args) -> int:
    from ibu_tpu_torch.pipelines import concat_files

    stats = concat_files(args.inputs, args.output)
    order = "sorted" if stats["sorted"] else "unsorted"
    print(
        f"concatenated {stats['files']} files -> {args.output}: "
        f"{stats['records']} records ({order})"
    )
    return 0


def cmd_subsample(args) -> int:
    from ibu_tpu_torch.pipelines import subsample_file

    stats = subsample_file(args.input, args.output,
                           fraction=args.fraction, n=args.n, seed=args.seed)
    print(
        f"subsampled {args.input} -> {args.output}: {stats['sampled']} of "
        f"{stats['records']} records (seed {stats['seed']})"
    )
    return 0


def cmd_repair(args) -> int:
    from ibu_tpu_torch.pipelines import repair_file

    stats = repair_file(args.input, args.output,
                        bc_len=args.bc_len, umi_len=args.umi_len)
    for a in stats["actions"]:
        print(f"repair: {a}", file=sys.stderr)
    order = "sorted" if stats["sorted"] else "unsorted"
    print(
        f"repaired {args.input} -> {args.output}: {stats['records']} "
        f"records salvaged ({order}, {stats['dropped_bytes']} bytes dropped)"
    )
    return 0


def cmd_ingest_fastq(args) -> int:
    from ibu_tpu_torch.pipelines import ingest_fastq

    n = ingest_fastq(args.input, args.output, args.bc_len, args.umi_len, device=args.device)
    print(f"# ingested {n} reads -> {args.output} (sorted)", file=sys.stderr)
    return 0


def cmd_export_fastq(args) -> int:
    from ibu_tpu_torch.pipelines import export_fastq

    n = export_fastq(args.input, args.output, qual=args.qual, device=args.device)
    print(f"# exported {n} reads -> {args.output}", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ibu_tpu_torch", description=__doc__)
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("info", help="print header metadata and record count")
    p.add_argument("path")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("stats", help="count + exact field checksums")
    p.add_argument("path")
    p.add_argument(
        "--engine", choices=("auto", "device", "native", "host"),
        default="auto",
        help="auto (default): probe the host->device link once and run "
             "the fastest engine on this box, announcing the choice on "
             "stderr; device: streamed to the CUDA card; "
             "native: threaded host engine; host: single-thread numpy",
    )
    _add_device_arg(p)
    _add_distributed_args(p)
    p.set_defaults(fn=cmd_stats)

    p = sub.add_parser("sort", help="sorted rewrite (native external merge "
                                    "sort, or in-memory device sort)")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--engine", choices=("native", "device", "mesh", "pod"),
                   default="native",
                   help="native: out-of-core external merge sort; device: "
                        "in-memory sort on the CUDA card (header-hinted); "
                        "mesh: sample sort over the cohort's cards (files up "
                        "to their total memory); pod (with --distributed): "
                        "auto: mesh on CUDA cards that hold the file, "
                        "shared-FS native external sample sort elsewhere")
    p.add_argument("--chunk-records", type=int, default=0)
    p.add_argument("--threads", type=int, default=0)
    _add_device_arg(p)
    _add_distributed_args(p)
    p.set_defaults(fn=cmd_sort)

    p = sub.add_parser("histogram", help="per-barcode counts")
    p.add_argument("path")
    p.add_argument("--top", type=int, default=20)
    p.add_argument(
        "--engine", choices=("auto", "device", "host"), default="auto",
        help="auto (default): probe the host->device link once and pick "
             "device vs host; device: per-batch histogram on the CUDA card; "
             "host: numpy np.unique merge (no device)",
    )
    p.add_argument("--max-uniques", type=int, default=1 << 16,
                   help="per-batch unique-barcode capacity")
    p.add_argument("--device-table", type=int, default=0, metavar="CAP",
                   help="merge batches on the device in a CAP-entry table "
                        "(bounded barcode spaces; default: host-dict merge; "
                        "--distributed always uses the device table, "
                        "spilling exactly past CAP)")
    _add_device_arg(p)
    _add_distributed_args(p)
    p.set_defaults(fn=cmd_histogram)

    p = sub.add_parser("decode", help="records → TSV (barcode, umi, index)")
    p.add_argument("path", help="IBU file, or - for stdin")
    p.add_argument("--limit", type=int, default=0)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_decode)

    p = sub.add_parser("split", help="partition into N standalone IBU shards")
    p.add_argument("input")
    p.add_argument("template", help="output name template, e.g. shard{}.ibu")
    p.add_argument("shards", type=int)
    p.set_defaults(fn=cmd_split)

    p = sub.add_parser("merge", help="k-way merge of sorted IBU files")
    p.add_argument("output")
    p.add_argument("inputs", nargs="+")
    p.set_defaults(fn=cmd_merge)

    p = sub.add_parser(
        "check",
        help="deep integrity audit: header, truncation, field ranges, "
             "sorted-flag truth (exit 1 if corrupt)",
    )
    p.add_argument("path")
    p.add_argument("--json", action="store_true",
                   help="emit the full report as one JSON line")
    p.set_defaults(fn=cmd_check)

    p = sub.add_parser(
        "subsample",
        help="keep a seeded uniform random subset of records "
             "(order-preserving, exact count)",
    )
    p.add_argument("input")
    p.add_argument("output")
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--fraction", type=float, default=None,
                   help="keep round(fraction * N) records")
    g.add_argument("--n", type=int, default=None,
                   help="keep exactly N records")
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_subsample)

    p = sub.add_parser(
        "repair",
        help="salvage intact records from a damaged file, with a "
             "truthful sorted flag",
    )
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--bc-len", type=int, default=None,
                   help="force barcode length (salvages files with a "
                        "destroyed header; requires --umi-len)")
    p.add_argument("--umi-len", type=int, default=None)
    p.set_defaults(fn=cmd_repair)

    p = sub.add_parser(
        "concat",
        help="concatenate IBU files (sorted flag preserved when the "
             "boundary order allows)",
    )
    p.add_argument("output")
    p.add_argument("inputs", nargs="+")
    p.set_defaults(fn=cmd_concat)

    p = sub.add_parser(
        "filter",
        help="keep only records whose barcode is in an allowlist",
    )
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument(
        "--barcodes", required=True,
        help="allowlist file: one barcode per line (ACGT sequence of the "
             "file's bc length, or an integer)",
    )
    p.add_argument(
        "--invert", action="store_true",
        help="keep records whose barcode is NOT in the list",
    )
    p.set_defaults(fn=cmd_filter)

    p = sub.add_parser(
        "lookup",
        help="pull all records for given barcodes from a SORTED file via "
             "binary search (O(log n) page touches, no scan)",
    )
    p.add_argument("path")
    p.add_argument("barcode", nargs="+",
                   help="ACGT sequence of the file's bc length, or an "
                        "integer (decimal or 0x hex)")
    p.set_defaults(fn=cmd_lookup)

    p = sub.add_parser(
        "cells",
        help="call cell barcodes from the rank-count knee; writes the "
             "allowlist that correct/filter consume",
    )
    p.add_argument("input")
    p.add_argument("-o", "--output", required=True,
                   help="allowlist output: one ACGT barcode per line, "
                        "descending by count")
    p.add_argument("--method", choices=("knee", "ordmag"), default="knee",
                   help="knee: max deviation below the log-log chord "
                        "(parameter-free); ordmag: keep barcodes within "
                        "10x of the top cells' 99th-percentile count")
    p.add_argument("--expect", type=int, default=3000,
                   help="expected cell count (ordmag method only)")
    p.add_argument("--min-count", type=int, default=1,
                   help="hard floor: a barcode needs at least this many "
                        "reads to be called")
    p.add_argument("--engine", choices=("host", "device"), default="host",
                   help="device: histogram on the CUDA card")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_cells)

    p = sub.add_parser(
        "count",
        help="barcode x index molecule-count matrix (MatrixMarket trio)",
    )
    p.add_argument("input")
    p.add_argument("prefix", help="output prefix: writes {prefix}.mtx, "
                                  "{prefix}.barcodes.txt, {prefix}.indices.txt")
    p.add_argument("--raw-reads", action="store_true",
                   help="count raw reads per (barcode, index) instead of "
                        "UMI-deduplicated molecules")
    p.add_argument("--engine", choices=("host", "device"), default="host",
                   help="device: per-batch 6-key sort + segment count on "
                        "the CUDA card (sorted inputs, dedup mode only)")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_count)

    p = sub.add_parser(
        "correct",
        help="correct barcode sequencing errors against an allowlist "
             "(Hamming distance <= 1; ambiguous/unmatched records dropped)",
    )
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument(
        "--barcodes", required=True,
        help="allowlist file: one barcode per line (ACGT sequence of the "
             "file's bc length, or an integer)",
    )
    p.add_argument(
        "--keep-unmatched", action="store_true",
        help="pass unmatched/ambiguous records through unchanged instead "
             "of dropping them",
    )
    _add_device_arg(p)
    p.set_defaults(fn=cmd_correct)

    p = sub.add_parser(
        "dedup",
        help="collapse PCR duplicates: one record per (barcode, umi) pair",
    )
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument(
        "--assume-sorted",
        choices=("auto", "yes", "no"),
        default="auto",
        help="auto: trust the header's sorted flag; yes: treat as sorted "
             "even without the flag (order is still verified during the "
             "pass); no: force a pre-sort (the fix for a lying flag)",
    )
    _add_device_arg(p)
    p.set_defaults(fn=cmd_dedup)

    p = sub.add_parser("ingest-fastq",
                       help="FASTQ → sorted IBU (encode on the CUDA card, native sort)")
    p.add_argument("input", help="FASTQ file (.gz ok)")
    p.add_argument("output", help="IBU output")
    p.add_argument("--bc-len", type=int, default=16)
    p.add_argument("--umi-len", type=int, default=12)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_ingest_fastq)

    p = sub.add_parser("export-fastq",
                       help="records → FASTQ (decode on the CUDA card)")
    p.add_argument("input", help="IBU file")
    p.add_argument("output", help="FASTQ output (.gz compresses)")
    p.add_argument("--qual", default="I", help="constant quality character")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_export_fastq)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except NoCardError:
        print(f"ibu_tpu_torch {args.command}: {NO_CARD_HINT}", file=sys.stderr)
        return 2
    except (IbuError, ValueError, OSError) as e:
        # operator-facing tools report bad inputs (missing files, compressed
        # files where random access is needed, corrupt headers, dimension
        # mismatches) as one line, not a traceback
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
