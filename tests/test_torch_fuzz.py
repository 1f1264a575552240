"""Randomized end-to-end roundtrips of the port across the configuration
space, the counterpart of ``tests/test_fuzz.py``.

The same seeds (``1000 + seed``) and the same draws in the same order:
``bc_len`` and ``umi_len`` in 1..32, ``n`` in 1..4999, ``ACGTacgt`` input,
indices below 2^63, random compression and batch sizes. Each leg runs through
the port on ``device="cpu"`` and is held against the host oracle of the
reference's test and against ``ibu_tpu``'s same call on the JAX CPU backend,
files byte for byte: encode → sort (hinted or not) → write (gzip or zstd) →
``Reader`` / ``MmapReader`` / ``stream_file_stats`` → decode; FASTQ export;
dedup and filter; the brute-force correction oracle on decoded rows; audit,
subsample, split → concat, repair and lookup; the count matrix and cell
calling. The ``cuda`` cases rerun the codec, sort and stats legs on the card
(held against the host oracles and the port's CPU results) and skip where
there is none; they import no jax, so they run on a machine without it.

CI runs 8 seeds; set ``FUZZ_SEEDS=N`` for an extended sweep.
"""

import filecmp
import os

import numpy as np
import pytest
import torch

from ibu_tpu_torch import Header, MmapReader, Reader, Writer, sort_records
from ibu_tpu_torch import pipelines as TPL
from ibu_tpu_torch.ops import codec as C
from ibu_tpu_torch.ops.stats import checksum_records_np, molecule_counts_np, pair_molecule_counts_np
from ibu_tpu_torch.parallel.device import stream_file_stats

SEEDS = range(int(os.environ.get("FUZZ_SEEDS", 8)))


def same_outcome(fn_port, fn_ref):
    """Run both; equal results, or the same error type and text."""
    def run(fn):
        try:
            return ("ok", fn())
        except Exception as e:  # noqa: BLE001 (the error is the result compared)
            return ("error", type(e).__name__, str(e))

    got, want = run(fn_port), run(fn_ref)
    if got[0] == want[0] == "ok" and isinstance(got[1], np.ndarray):
        assert got[1].tobytes() == np.asarray(want[1]).tobytes()
    else:
        assert got == want
    return got[1] if got[0] == "ok" else None


def same_files(a: str, b: str, suffixes=("",)) -> None:
    for sfx in suffixes:
        assert filecmp.cmp(a + sfx, b + sfx, shallow=False), (a + sfx, b + sfx)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("seed", SEEDS)
def test_random_roundtrip_config(seed, device, tmp_path):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    on_cpu = device == "cpu"
    if on_cpu:  # the reference, on the JAX CPU backend
        import ibu_tpu
        from ibu_tpu import pipelines as JPL
        from ibu_tpu.parallel.device import stream_file_stats as j_stream_file_stats

    rng = np.random.default_rng(1000 + seed)
    bc_len = int(rng.integers(1, 33))
    umi_len = int(rng.integers(1, 33))
    n = int(rng.integers(1, 5000))
    compress = bool(rng.integers(0, 2))
    al = np.frombuffer(b"ACGTacgt", dtype=np.uint8)

    bc_rows = al[rng.integers(0, 8, (n, bc_len))]
    umi_rows = al[rng.integers(0, 8, (n, umi_len))]
    index = rng.integers(0, 1 << 63, n, dtype=np.uint64)

    # encode vs the host oracle (and the reference's device encode)
    records = TPL.encode_batch(bc_rows, umi_rows, index, engine="device", device=device)
    assert np.array_equal(records["barcode"], C.np_pack(bc_rows))
    assert np.array_equal(records["umi"], C.np_pack(umi_rows))
    assert np.array_equal(records["index"], index)
    if on_cpu:
        assert records.tobytes() == JPL.encode_batch(bc_rows, umi_rows, index).tobytes()
    else:
        cpu = TPL.encode_batch(bc_rows, umi_rows, index, engine="device", device="cpu")
        assert records.tobytes() == cpu.tobytes()

    # device sort vs host sort, hinted (truthful by construction) or not
    hints = ({"bc_len": bc_len, "umi_len": umi_len, "index_bits": 63}
             if rng.integers(0, 2) else {})
    unsorted = records
    records = TPL.sort_batch(unsorted, device=device, **hints)
    assert np.array_equal(records, sort_records(records.copy()))
    if on_cpu:
        assert records.tobytes() == JPL.sort_batch(unsorted, **hints).tobytes()

    # write → (maybe compressed) stream read → byte equality
    header = Header.new(bc_len, umi_len)
    header.set_sorted()
    w = Writer.in_memory(header)
    w.write_batch(records)
    w.finish()
    raw = w.inner.getvalue()
    assert len(raw) == 32 + 24 * n
    if on_cpu:
        jw = ibu_tpu.Writer.in_memory(ibu_tpu.Header.from_bytes(header.as_bytes()))
        jw.write_batch(records)
        jw.finish()
        assert jw.inner.getvalue() == raw

    path = tmp_path / f"f{seed}.ibu"
    if compress:
        kind = "gzip" if rng.integers(0, 2) else "zstd"
        try:
            import zstandard  # noqa: F401
        except ImportError:
            kind = "gzip"
        path = tmp_path / f"f{seed}.ibu.{'gz' if kind == 'gzip' else 'zst'}"
        with Writer.from_path(str(path), header, compression=kind) as cw:
            cw.write_batch(records)
        if on_cpu:  # the reference's compressed file reads back to the same bytes
            jpath = str(tmp_path / f"j{seed}.ibu.{'gz' if kind == 'gzip' else 'zst'}")
            with ibu_tpu.Writer.from_path(jpath, ibu_tpu.Header.from_bytes(header.as_bytes()),
                                          compression=kind) as jcw:
                jcw.write_batch(records)
            for p in (str(path), jpath):
                for pkg_reader in (Reader, ibu_tpu.Reader):
                    back = np.concatenate(list(pkg_reader.from_path(p).batches()))
                    assert back.tobytes() == raw[32:]
    else:
        path.write_bytes(raw)
    r = Reader.from_path(str(path))
    got_header = r.header()
    assert (got_header.bc_len, got_header.umi_len) == (bc_len, umi_len)
    assert got_header.sorted()
    back = np.concatenate(list(r.batches()))
    assert np.array_equal(back, records)

    # decode back to uppercase sequences
    bc2, umi2, idx2 = TPL.decode_batch(records, bc_len, umi_len, engine="device", device=device)
    want = sorted((bytes(b).upper(), bytes(u).upper(), int(i))
                  for b, u, i in zip(bc_rows, umi_rows, index))
    got = sorted((bytes(b), bytes(u), int(i)) for b, u, i in zip(bc2, umi2, idx2))
    assert got == want
    if on_cpu:
        for a, b in zip((bc2, umi2, idx2), JPL.decode_batch(records, bc_len, umi_len)):
            assert np.array_equal(a, np.asarray(b))

    if compress:
        return

    # mmap + streamed device stats
    mm = MmapReader(str(path))
    batch_records = int(rng.integers(1, n + 1))
    stats = stream_file_stats(mm, device=device, batch_records=batch_records)
    assert stats["count"] == n
    assert (stats["barcode_sum"], stats["umi_sum"], stats["index_sum"]) == \
        checksum_records_np(records)
    if not on_cpu:
        return  # the card reruns the codec, sort and stats legs only
    assert stats == j_stream_file_stats(ibu_tpu.MmapReader(str(path)),
                                        batch_records=batch_records)

    def on_cpu_of(P):
        """The port's device argument; the reference takes none."""
        return {"device": "cpu"} if P is TPL else {}

    def both(name, fn):
        """``fn(pipelines module, output path)`` through both packages: the
        same result (or error) and the same file bytes."""
        mine, theirs = str(tmp_path / f"t{seed}.{name}"), str(tmp_path / f"j{seed}.{name}")
        result = same_outcome(lambda: fn(TPL, mine), lambda: fn(JPL, theirs))
        return result, mine, theirs

    # FASTQ export + a re-parse of one record
    exported, fq, jfq = both("fastq", lambda P, out: P.export_fastq(
        str(path), out, batch_records=batch_records,
        **on_cpu_of(P)))
    assert exported == n
    same_files(fq, jfq)
    lines = open(fq, "rb").read().splitlines()
    assert len(lines) == 4 * n
    k = int(rng.integers(0, n))
    srt = np.sort(records, order=("barcode", "umi", "index"))
    want_seq = (C.decode_seqs(srt["barcode"][k:k + 1], bc_len)[0]
                + C.decode_seqs(srt["umi"][k:k + 1], umi_len)[0]).encode()
    assert lines[4 * k + 1] == want_seq
    assert int(lines[4 * k][2:]) == int(srt["index"][k])

    # dedup + filter vs set-based host oracles
    dstats, dd, jdd = both("dedup.ibu", lambda P, out: P.dedup_file(
        str(path), out, **on_cpu_of(P)))
    want_mol = molecule_counts_np(records)
    assert dstats["records"] == n
    assert dstats["molecules"] == sum(want_mol.values())
    assert dstats["barcodes"] == len(want_mol)
    same_files(dd, jdd)
    allow = rng.choice(records["barcode"], size=int(rng.integers(1, 4)), replace=True)
    fstats, ff, jff = both("filt.ibu", lambda P, out: P.filter_file(str(path), out, allow))
    assert fstats["kept"] == int(np.isin(records["barcode"], allow).sum())
    assert np.array_equal(np.asarray(MmapReader(ff).records),
                          records[np.isin(records["barcode"], allow)])
    same_files(ff, jff)

    # barcode correction vs a brute-force oracle on DECODED base rows
    base = rng.choice(records["barcode"], size=int(rng.integers(1, 5)), replace=True)
    mut = base ^ (rng.integers(1, 4, len(base)).astype(np.uint64)
                  << (2 * rng.integers(0, bc_len, len(base)).astype(np.uint64)))
    allow = np.unique(np.concatenate([base, mut]))
    rows = C.np_unpack(records["barcode"], bc_len)
    arows = C.np_unpack(allow, bc_len)
    dist = (rows[:, None, :] != arows[None, :, :]).sum(axis=2)
    is_exact = (dist == 0).any(axis=1)
    n1 = (dist == 1).sum(axis=1)
    keep = is_exact | (n1 == 1)
    fixed_bc = records["barcode"].copy()
    fix_rows = ~is_exact & (n1 == 1)
    fixed_bc[fix_rows] = allow[(dist == 1).argmax(axis=1)[fix_rows]]
    want_kept = records[keep].copy()
    want_kept["barcode"] = fixed_bc[keep]
    cstats, co, jco = both("corr.ibu", lambda P, out: P.correct_file(
        str(path), out, allow, **on_cpu_of(P)))
    assert cstats["exact"] == int(is_exact.sum())
    assert cstats["corrected"] == int(fix_rows.sum())
    assert cstats["dropped"] == n - int(keep.sum())
    assert np.array_equal(np.asarray(MmapReader(co).records), want_kept)
    same_files(co, jco)

    # audit + subsample + split → concat + repair
    rep = same_outcome(lambda: TPL.check_file(str(path)), lambda: JPL.check_file(str(path)))
    assert rep["ok"] and rep["records"] == n

    k = int(rng.integers(0, n + 1))
    sstats, ss, jss = both("sub.ibu", lambda P, out: P.subsample_file(
        str(path), out, n=k, seed=seed, batch_records=batch_records))
    assert sstats["sampled"] == k
    sub = np.asarray(MmapReader(ss).records)
    assert len(sub) == k
    v_all = np.ascontiguousarray(records).view("V24").ravel()
    assert np.isin(np.ascontiguousarray(sub).view("V24").ravel(), v_all).all()
    same_files(ss, jss)

    n_shards = int(rng.integers(1, 5))
    shards = TPL.split_file(str(path), str(tmp_path / f"t{seed}.s{{}}.ibu"), n_shards)
    jshards = JPL.split_file(str(path), str(tmp_path / f"j{seed}.s{{}}.ibu"), n_shards)
    assert len(shards) == len(jshards)
    for a, b in zip(shards, jshards):
        same_files(a, b)
    cat_stats, cc, jcc = both("cat.ibu", lambda P, out: P.concat_files(
        shards if P is TPL else jshards, out))
    assert cat_stats["records"] == n and cat_stats["sorted"]
    assert open(cc, "rb").read() == path.read_bytes()  # byte-exact inverse
    same_files(cc, jcc)

    # indexed lookup vs the isin oracle (the file is sorted, the flag set)
    qs = np.concatenate([rng.choice(records["barcode"], size=int(rng.integers(1, 4))),
                         np.array([0xDEAD_BEEF_DEAD_BEEF], dtype=np.uint64)])
    hits = same_outcome(lambda: TPL.lookup_barcodes(str(path), qs),
                        lambda: JPL.lookup_barcodes(str(path), qs))
    assert np.array_equal(hits, records[np.isin(records["barcode"], qs)])

    # count matrix (sorted fast path) vs the pair-triple oracle
    want_pairs = pair_molecule_counts_np(records)
    mstats, cm, jcm = both("cm", lambda P, out: P.count_matrix(
        str(path), out, batch_records=batch_records))
    assert mstats["entries"] == len(want_pairs)
    assert mstats["molecules"] == sum(want_pairs.values())
    same_files(cm, jcm, (".mtx", ".barcodes.txt", ".indices.txt"))

    # cell calling: the emitted allowlist is the barcodes at or above the threshold
    method = "knee" if rng.integers(0, 2) else "ordmag"
    kst, allowf, jallowf = both("cells.txt", lambda P, out: P.call_cells(
        str(path), out, method=method, batch_records=batch_records))
    u, c = np.unique(records["barcode"], return_counts=True)
    assert kst["barcodes"] == len(u) and kst["records"] == n
    want_cells = set(u[c >= kst["threshold"]].tolist())
    listed = [line.strip() for line in open(allowf).read().splitlines() if line.strip()]
    got_cells = set(int(v) for v in np.asarray(C.encode_seqs(listed))) if listed else set()
    assert got_cells == want_cells and kst["cells"] == len(want_cells)
    same_files(allowf, jallowf)

    cut = int(rng.integers(1, 24))  # always tears the last record
    bad = tmp_path / f"f{seed}.bad.ibu"
    bad.write_bytes(path.read_bytes()[:-cut])
    assert not same_outcome(lambda: TPL.check_file(str(bad)),
                            lambda: JPL.check_file(str(bad)))["ok"]
    rstats, rr, jrr = both("rep.ibu", lambda P, out: P.repair_file(str(bad), out))
    assert rstats["records"] == n - 1
    assert rstats["dropped_bytes"] == 24 - cut
    assert np.array_equal(np.asarray(MmapReader(rr).records), records[: n - 1])
    assert TPL.check_file(rr)["ok"]
    same_files(rr, jrr)
