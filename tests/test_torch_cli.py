"""``python -m ibu_tpu_torch`` against ``python -m ibu_tpu``, command by
command, on the same input files.

Each case runs ``main(argv)`` of both packages in-process, each in its own
empty working directory (outputs are relative names there), the port with
``--device cpu`` on the commands that take it. Exit code, standard output,
standard error (after :func:`port_text`) and every file written must be
equal, with tolerance 0; a gzip output is compared byte for byte except the
4-byte time stamp its header carries. The inputs are a few thousand records
made from a numpy seed, plain, gzip and zstd.
"""

import gzip
import io
import json
import re
import subprocess
import sys
from functools import partial
from pathlib import Path

import numpy as np
import pytest

from ibu_tpu import pipelines as JPL
from ibu_tpu.__main__ import main as jax_main
from ibu_tpu.parallel import select as JSEL
from ibu_tpu_torch import Header, Writer, make_records
from ibu_tpu_torch import pipelines as TPL
from ibu_tpu_torch.__main__ import main as torch_main
from ibu_tpu_torch.ops.codec import decode_seqs
from ibu_tpu_torch.parallel import select as TSEL

try:
    import zstandard  # noqa: F401

    HAVE_ZSTD = True
except ImportError:  # the zstd cases are then not generated
    HAVE_ZSTD = False

REPO = Path(__file__).resolve().parents[1]

#: the commands that take ``--device`` in the port
DEVICE_COMMANDS = {"stats", "sort", "histogram", "decode", "cells", "count", "correct",
                   "dedup", "ingest-fastq", "export-fastq"}
SUBCOMMANDS = {"info", "stats", "sort", "histogram", "decode", "split", "merge", "check",
               "subsample", "repair", "concat", "filter", "lookup", "cells", "count",
               "correct", "dedup", "ingest-fastq", "export-fastq"}


def port_text(text: str) -> str:
    """A text of the JAX package as the port words it: where it names its
    own command, the port names ``python -m ibu_tpu_torch``; where it names
    the TPU or the jax mesh, the port names the CUDA cards of its cohort."""
    return (text.replace("python -m ibu_tpu ", "python -m ibu_tpu_torch ")
            .replace("the jax device mesh", "the cohort's cards")
            .replace("mesh on TPU", "mesh on CUDA cards")
            .replace("(no TPU)", "(no card)"))


def write(path, records, sorted_flag=False, bc_len=16, umi_len=12):
    header = Header.new(bc_len, umi_len)
    if sorted_flag:
        header.set_sorted()
    with Writer.from_path(str(path), header) as w:
        w.write_batch(records)
    return str(path)


def by_key(records):
    return np.sort(records, order=("barcode", "umi", "index"))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Every input of the cases, by name."""
    d = tmp_path_factory.mktemp("cli_inputs")
    rng = np.random.default_rng(31)
    n = 5000
    plain = by_key(make_records(rng.integers(0, 50, n).astype(np.uint64),
                                rng.integers(0, 9, n).astype(np.uint64),
                                rng.integers(0, 1 << 20, n).astype(np.uint64)))
    f = {"P": write(d / "a.ibu", plain, sorted_flag=True)}
    f["GZ"] = str(d / "a.ibu.gz")
    Path(f["GZ"]).write_bytes(gzip.compress(Path(f["P"]).read_bytes()))
    if HAVE_ZSTD:
        import zstandard

        f["ZST"] = str(d / "a.ibu.zst")
        Path(f["ZST"]).write_bytes(zstandard.ZstdCompressor().compress(Path(f["P"]).read_bytes()))
    later = by_key(make_records(rng.integers(40, 90, 700).astype(np.uint64),
                                rng.integers(0, 9, 700).astype(np.uint64),
                                rng.integers(0, 1 << 20, 700).astype(np.uint64)))
    f["B"] = write(d / "b.ibu", later, sorted_flag=True)
    f["S0"], f["S1"] = JPL.split_file(f["P"], str(d / "shard{}.ibu"), 2)

    # five planted cells over sixty ambient barcodes, shuffled, 16 genes
    barcodes = rng.choice(1 << 32, 65, replace=False).astype(np.uint64)
    counts = np.concatenate([rng.integers(60, 90, 5), rng.integers(1, 4, 60)])
    bc = np.repeat(barcodes, counts)
    rng.shuffle(bc)
    m = len(bc)
    cells = make_records(bc, rng.integers(0, 6, m).astype(np.uint64),
                         rng.integers(0, 16, m).astype(np.uint64))
    f["C"] = write(d / "c.ibu", cells)
    f["CS"] = write(d / "cs.ibu", by_key(cells), sorted_flag=True)
    f["CELLS"] = str(d / "cells.txt")
    Path(f["CELLS"]).write_text("".join(s + "\n" for s in decode_seqs(barcodes[:5], 16)))
    f["LIE"] = write(d / "lie.ibu", cells[:50], sorted_flag=True)

    seq3 = decode_seqs(np.array([3], np.uint64), 16)[0]
    f["SEQ3"] = seq3
    f["ALLOW"] = str(d / "allow.txt")
    Path(f["ALLOW"]).write_text(f"# comment\n{seq3}\n{seq3.lower()}\n7\n0x9\n\n12345\n")
    for name, text in (("BADLEN", "ACGT\n"), ("BADWORD", "hello\n"), ("BADRANGE", f"{1 << 64}\n")):
        f[name] = str(d / f"{name.lower()}.txt")
        Path(f[name]).write_text(text)

    data = Path(f["P"]).read_bytes()
    f["TORN"] = str(d / "torn.ibu")
    Path(f["TORN"]).write_bytes(data[: 32 + 24 * 1234 + 11])
    f["NOHDR"] = str(d / "nohdr.ibu")
    Path(f["NOHDR"]).write_bytes(b"\0" * 32 + data[32:])
    f["MISSING"] = str(d / "nope.ibu")

    # 300 reads of 30 bases: barcode, UMI and two more
    reads = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (300, 30))]
    fastq = b"".join(b"@read%d\n%s\n+\n%s\n" % (i, bytes(r), b"I" * 30)
                     for i, r in enumerate(reads))
    f["FQ"] = str(d / "r.fastq")
    Path(f["FQ"]).write_bytes(fastq)
    f["FQGZ"] = str(d / "r.fastq.gz")
    Path(f["FQGZ"]).write_bytes(gzip.compress(fastq))
    return f


#: (case id, argv with {NAME} for an input of ``files``, standard input, env)
CASES = [
    ("info plain", ["info", "{P}"]),
    ("info gzip", ["info", "{GZ}"]),
    ("info missing", ["info", "{MISSING}"]),
    ("stats auto", ["stats", "{P}"]),
    ("stats auto override", ["stats", "{P}"], None, {"IBU_AUTO_ENGINE": "host"}),
    ("stats device", ["stats", "{P}", "--engine", "device"]),
    ("stats native", ["stats", "{P}", "--engine", "native"]),
    ("stats host", ["stats", "{P}", "--engine", "host"]),
    ("stats gzip", ["stats", "{GZ}"]),
    ("stats gzip device", ["stats", "{GZ}", "--engine", "device"]),
    ("stats gzip native", ["stats", "{GZ}", "--engine", "native"]),
    ("stats missing", ["stats", "{MISSING}"]),
    ("sort native", ["sort", "{C}", "o.ibu"]),
    ("sort native chunks", ["sort", "{C}", "o.ibu", "--chunk-records", "70", "--threads", "2"]),
    ("sort device", ["sort", "{C}", "o.ibu", "--engine", "device"]),
    ("sort device threads", ["sort", "{C}", "o.ibu", "--engine", "device", "--threads", "2"]),
    ("sort gzip", ["sort", "{GZ}", "o.ibu"]),
    ("sort gzip device", ["sort", "{GZ}", "o.ibu", "--engine", "device"]),
    ("sort missing", ["sort", "{MISSING}", "o.ibu"]),
    ("sort mesh", ["sort", "{C}", "o.ibu", "--engine", "mesh"]),
    ("sort mesh threads", ["sort", "{C}", "o.ibu", "--engine", "mesh", "--threads", "2"]),
    ("sort pod", ["sort", "{C}", "o.ibu", "--engine", "pod", "--chunk-records", "70"]),
    ("sort pod override", ["sort", "{C}", "o.ibu", "--engine", "pod"], None,
     {"IBU_POD_SORT_ENGINE": "mesh"}),
    ("sort pod bad override", ["sort", "{C}", "o.ibu", "--engine", "pod"], None,
     {"IBU_POD_SORT_ENGINE": "bogus"}),
    ("sort distributed native", ["sort", "{C}", "o.ibu", "--distributed"]),
    ("sort mesh gzip", ["sort", "{GZ}", "o.ibu", "--engine", "mesh"]),
    ("stats distributed native", ["stats", "{P}", "--distributed", "--engine", "native"]),
    ("stats distributed gzip", ["stats", "{GZ}", "--distributed"]),
    ("histogram distributed host", ["histogram", "{P}", "--distributed", "--engine", "host"]),
    ("histogram distributed gzip", ["histogram", "{GZ}", "--distributed"]),
    ("histogram plain", ["histogram", "{P}", "--top", "5"]),
    ("histogram gzip", ["histogram", "{GZ}", "--top", "5"]),
    ("histogram device", ["histogram", "{P}", "--top", "5", "--engine", "device"]),
    ("histogram host", ["histogram", "{P}", "--top", "5", "--engine", "host"]),
    ("histogram host table", ["histogram", "{P}", "--engine", "host", "--device-table", "1024"]),
    ("histogram table", ["histogram", "{C}", "--device-table", "4096"]),
    ("histogram gzip device", ["histogram", "{GZ}", "--engine", "device", "--top", "3"]),
    ("histogram missing", ["histogram", "{MISSING}"]),
    ("decode", ["decode", "{P}"]),
    ("decode limit", ["decode", "{P}", "--limit", "7"]),
    ("decode gzip", ["decode", "{GZ}", "--limit", "100"]),
    ("decode stdin", ["decode", "-"], "P"),
    ("decode stdin gzip", ["decode", "-", "--limit", "9"], "GZ"),
    ("split", ["split", "{P}", "s{}.ibu", "3"]),
    ("split gzip", ["split", "{GZ}", "s{}.ibu", "2"]),
    ("merge", ["merge", "m.ibu", "{S0}", "{S1}"]),
    ("merge unsorted", ["merge", "m.ibu", "{C}", "{P}"]),
    ("check", ["check", "{P}"]),
    ("check json", ["check", "{P}", "--json"]),
    ("check torn", ["check", "{TORN}"]),
    ("check torn json", ["check", "{TORN}", "--json"]),
    ("check gzip json", ["check", "{GZ}", "--json"]),
    ("subsample fraction", ["subsample", "{P}", "o.ibu", "--fraction", "0.1"]),
    ("subsample n seed", ["subsample", "{P}", "o.ibu", "--n", "17", "--seed", "3"]),
    ("subsample gzip", ["subsample", "{GZ}", "o.ibu", "--n", "5"]),
    ("repair torn", ["repair", "{TORN}", "o.ibu"]),
    ("repair header lengths", ["repair", "{NOHDR}", "o.ibu", "--bc-len", "16", "--umi-len", "12"]),
    ("repair header", ["repair", "{NOHDR}", "o.ibu"]),
    ("concat", ["concat", "o.ibu", "{P}", "{B}"]),
    ("concat out of order", ["concat", "o.ibu", "{B}", "{P}"]),
    ("concat gzip", ["concat", "o.ibu", "{GZ}", "{P}"]),
    ("filter", ["filter", "{P}", "o.ibu", "--barcodes", "{ALLOW}"]),
    ("filter invert", ["filter", "{P}", "o.ibu", "--barcodes", "{ALLOW}", "--invert"]),
    ("filter bad length", ["filter", "{P}", "o.ibu", "--barcodes", "{BADLEN}"]),
    ("filter bad word", ["filter", "{P}", "o.ibu", "--barcodes", "{BADWORD}"]),
    ("filter bad range", ["filter", "{P}", "o.ibu", "--barcodes", "{BADRANGE}"]),
    ("filter gzip", ["filter", "{GZ}", "o.ibu", "--barcodes", "{ALLOW}"]),
    ("lookup", ["lookup", "{P}", "{SEQ3}", "7", "0x9"]),
    ("lookup bad length", ["lookup", "{P}", "ACGT"]),
    ("lookup unsorted", ["lookup", "{C}", "1"]),
    ("lookup gzip", ["lookup", "{GZ}", "AAAAAAAAAAAAAAAA"]),
    ("cells knee", ["cells", "{C}", "-o", "cells.txt"]),
    ("cells ordmag", ["cells", "{C}", "-o", "cells.txt", "--method", "ordmag", "--expect", "5"]),
    ("cells min count", ["cells", "{C}", "-o", "cells.txt", "--min-count", "80"]),
    ("cells device", ["cells", "{C}", "-o", "cells.txt", "--engine", "device"]),
    ("cells gzip", ["cells", "{GZ}", "-o", "cells.txt"]),
    ("count", ["count", "{CS}", "m"]),
    ("count raw reads", ["count", "{CS}", "m", "--raw-reads"]),
    ("count device", ["count", "{CS}", "m", "--engine", "device"]),
    ("count lying flag", ["count", "{LIE}", "m"]),
    ("count gzip", ["count", "{GZ}", "m"]),
    ("correct", ["correct", "{C}", "o.ibu", "--barcodes", "{CELLS}"]),
    ("correct keep", ["correct", "{C}", "o.ibu", "--barcodes", "{CELLS}", "--keep-unmatched"]),
    ("correct gzip", ["correct", "{GZ}", "o.ibu", "--barcodes", "{CELLS}"]),
    ("dedup sorted", ["dedup", "{CS}", "o.ibu"]),
    ("dedup unsorted", ["dedup", "{C}", "o.ibu"]),
    ("dedup presort", ["dedup", "{CS}", "o.ibu", "--assume-sorted", "no"]),
    ("dedup lying flag", ["dedup", "{LIE}", "o.ibu"]),
    ("dedup lying flag presort", ["dedup", "{LIE}", "o.ibu", "--assume-sorted", "no"]),
    ("dedup assume yes", ["dedup", "{C}", "o.ibu", "--assume-sorted", "yes"]),
    ("ingest-fastq", ["ingest-fastq", "{FQ}", "o.ibu"]),
    ("ingest-fastq gzip", ["ingest-fastq", "{FQGZ}", "o.ibu"]),
    ("ingest-fastq to gzip", ["ingest-fastq", "{FQ}", "o.ibu.gz"]),
    ("ingest-fastq lengths", ["ingest-fastq", "{FQ}", "o.ibu", "--bc-len", "10", "--umi-len", "8"]),
    ("export-fastq", ["export-fastq", "{P}", "o.fastq"]),
    ("export-fastq gzip", ["export-fastq", "{GZ}", "o.fastq"]),
    ("export-fastq to gzip", ["export-fastq", "{P}", "o.fastq.gz", "--qual", "#"]),
    # the codec on the device side: the plain torch versions against the lax path
    ("decode device codec", ["decode", "{P}"], None, {"IBU_AUTO_ENGINE": "device"}),
    ("ingest-fastq device codec", ["ingest-fastq", "{FQ}", "o.ibu"], None,
     {"IBU_AUTO_ENGINE": "device"}),
    ("export-fastq device codec", ["export-fastq", "{P}", "o.fastq"], None,
     {"IBU_AUTO_ENGINE": "device"}),
]
if HAVE_ZSTD:
    CASES += [
        ("info zstd", ["info", "{ZST}"]),
        ("stats zstd host", ["stats", "{ZST}", "--engine", "host"]),
        ("histogram zstd", ["histogram", "{ZST}", "--top", "4"]),
        ("ingest-fastq to zstd", ["ingest-fastq", "{FQ}", "o.ibu.zst"]),
    ]


@pytest.fixture(autouse=True)
def fixed_probes(monkeypatch):
    """The same probe readings in both packages, so that ``engine="auto"``
    decides and announces the same: a 0.5 GB/s feed (about 21 Mrec/s)
    against a 50 Mrec/s native engine."""
    monkeypatch.delenv("IBU_AUTO_ENGINE", raising=False)
    for sel in (JSEL, TSEL):
        sel.reset_probe_memo()
        sel._MEMO.update(device_gbps=0.5, native_recs=50e6)
    yield
    for sel in (JSEL, TSEL):
        sel.reset_probe_memo()


def run(main, argv, cwd, monkeypatch, capsys, stdin: bytes | None = None):
    """``(exit code, stdout, stderr)`` of ``main(argv)`` run in ``cwd``; an
    exit through ``SystemExit`` gives its code, or its message as the code
    with exit status 1, as the interpreter would."""
    monkeypatch.chdir(cwd)
    if stdin is not None:
        monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(stdin)))
    try:
        rc = main(argv)
    except SystemExit as e:
        rc = e.code
    out = capsys.readouterr()
    return rc, out.out, out.err


def written(directory: Path) -> dict[str, bytes]:
    """Every file under ``directory``; a gzip file without its time stamp."""
    out = {}
    for p in sorted(directory.iterdir()):
        data = p.read_bytes()
        if data[:2] == b"\x1f\x8b":
            data = data[:4] + data[8:]
        out[p.name] = data
    return out


def fill(argv, files):
    """``argv`` with each ``{NAME}`` replaced by that input's path (an output
    template such as ``s{}.ibu`` stays as it is)."""
    return [re.sub(r"\{([A-Z0-9]+)\}", lambda m: files[m.group(1)], a) for a in argv]


def both(argv, files, tmp_path, monkeypatch, capsys, stdin=None, env=None):
    """Run ``argv`` through both packages; returns both outcomes, each
    ``(rc, stdout, stderr, files written)``."""
    for key, value in (env or {}).items():
        monkeypatch.setenv(key, value)
    argv = fill(argv, files)
    data = Path(files[stdin]).read_bytes() if stdin else None
    port_argv = argv + (["--device", "cpu"] if argv[0] in DEVICE_COMMANDS else [])
    results = []
    for name, main, args in (("jax", jax_main, argv), ("torch", torch_main, port_argv)):
        cwd = tmp_path / name
        cwd.mkdir()
        results.append((*run(main, args, cwd, monkeypatch, capsys, data), written(cwd)))
    return results


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_command_matches_jax(case, files, tmp_path, monkeypatch, capsys):
    _, argv, *rest = case
    stdin, env = (rest + [None, None])[:2]
    (jrc, jout, jerr, jfiles), (trc, tout, terr, tfiles) = both(
        argv, files, tmp_path, monkeypatch, capsys, stdin, env)
    assert trc == (port_text(jrc) if isinstance(jrc, str) else jrc)
    assert tout == port_text(jout)
    assert terr == port_text(jerr)
    assert tfiles.keys() == jfiles.keys()
    for name in jfiles:
        assert tfiles[name] == jfiles[name], name


def test_the_cases_cover_every_subcommand():
    assert {case[1][0] for case in CASES} == SUBCOMMANDS


def test_count_device_refuses_past_max_pairs_like_jax(files, tmp_path, monkeypatch, capsys):
    """More distinct (barcode, index) pairs in a batch than ``max_pairs``:
    exit 1 and the reference's text. The command has no ``--max-pairs``, so
    the capacity is lowered in both packages' functions."""
    monkeypatch.setattr(JPL, "count_matrix", partial(JPL.count_matrix, max_pairs=16))
    monkeypatch.setattr(TPL, "count_matrix", partial(TPL.count_matrix, max_pairs=16))
    (jrc, jout, jerr, jfiles), (trc, tout, terr, tfiles) = both(
        ["count", "{CS}", "m", "--engine", "device"], files, tmp_path, monkeypatch, capsys)
    assert jrc == trc == 1 and jout == tout == ""
    assert terr == jerr and "over the max_pairs=16 device capacity" in terr
    assert tfiles == jfiles


def test_help_lists_the_subcommands(capsys):
    with pytest.raises(SystemExit) as done:
        torch_main(["--help"])
    assert done.value.code == 0
    listed = capsys.readouterr().out.split("{", 1)[1].split("}", 1)[0]
    assert set(listed.split(",")) == SUBCOMMANDS


@pytest.mark.parametrize("argv", [
    ["filter", "{P}", "o.ibu", "--barcodes", "{ALLOW}", "--distributed"],
    ["count", "{CS}", "m", "--distributed"],
    ["correct", "{C}", "o.ibu", "--barcodes", "{CELLS}", "--num-processes", "2"],
    ["dedup", "{CS}", "o.ibu", "--process-id", "0"],
    ["ingest-fastq", "{FQ}", "o.ibu", "--coordinator", "localhost:1"],
    ["export-fastq", "{P}", "o.fastq", "--distributed"],
], ids=["filter", "count", "correct", "dedup", "ingest-fastq", "export-fastq"])
def test_multihost_options_are_refused(argv, files, tmp_path, monkeypatch, capsys):
    """The six commands whose cohort engines are not ported yet refuse the
    distributed options: argparse exits 2 and nothing is written."""
    monkeypatch.chdir(tmp_path)
    argv = fill(argv, files) + (["--device", "cpu"] if argv[0] in DEVICE_COMMANDS else [])
    with pytest.raises(SystemExit) as done:
        torch_main(argv)
    assert done.value.code == 2
    err = capsys.readouterr().err
    assert "usage: ibu_tpu_torch" in err and "unrecognized arguments: --" in err
    assert not list(tmp_path.iterdir())


#: (case id, argv) run by a 2-rank cohort of the port with ``--distributed``
#: and by the JAX package in one process without it
COHORT_CASES = [
    ("stats", ["stats", "{P}"], None),
    ("histogram", ["histogram", "{C}", "--top", "20"], None),
    ("histogram table", ["histogram", "{C}", "--device-table", "32", "--top", "7"], None),
    ("sort mesh", ["sort", "{C}", "mesh.ibu", "--engine", "mesh"], None),
    ("sort pod", ["sort", "{C}", "pod.ibu", "--engine", "pod"], None),
    ("sort pod host", ["sort", "{C}", "host.ibu", "--engine", "pod"], "host"),
]


@pytest.fixture(scope="module")
def cohort(files, tmp_path_factory):
    """One 2-rank launch of the port's CLI: every cohort case, then the
    failure injected on rank 1. Each rank joins through the first command's
    flags, and runs in the launch's directory (outputs there)."""
    from tests.torch_cohort import launch

    d = tmp_path_factory.mktemp("cli_cohort")
    tasks = [(cid, "cli", {"argv": fill(argv, files) + ["--device", "cpu"], "env": env})
             for cid, argv, env in COHORT_CASES]
    tasks.append(("fail", "cli_failing_on_rank1",
                  {"argv": fill(["sort", "{C}", "fail.ibu", "--engine", "pod"], files)
                   + ["--device", "cpu"]}))
    return d, launch(2, tasks, d, init=False)


def _program_lines(err: str, prefixes=("# ", "pod sort engine auto:")) -> list[str]:
    return [line for line in err.splitlines() if line.startswith(prefixes)]


@pytest.mark.parametrize("case", COHORT_CASES, ids=[c[0] for c in COHORT_CASES])
def test_distributed_rank0_matches_jax(case, cohort, files, tmp_path, monkeypatch, capsys):
    """Rank 0 prints what the JAX CLI prints in one process (exit code and
    standard output exactly; on stderr the lines the program writes), rank 1
    prints nothing, and the file the cohort wrote is the JAX CLI's."""
    cid, argv, env = case
    d, ranks = cohort
    if env:
        monkeypatch.setenv("IBU_POD_SORT_ENGINE", env)
    jrc, jout, jerr = run(jax_main, fill(argv, files), tmp_path, monkeypatch, capsys)
    (rc0, out0, err0), (rc1, out1, err1) = (r[cid][1] for r in ranks)
    assert (rc0, out0) == (jrc, jout) and jrc == 0
    assert _program_lines(err0) == _program_lines(port_text(jerr))
    assert (rc1, out1) == (0, "")
    if argv[0] == "sort":
        assert (d / argv[2]).read_bytes() == (tmp_path / argv[2]).read_bytes()


def test_a_failure_on_rank1_ends_both_ranks(cohort):
    """Rank 1's run sort raises: both ranks exit 1 with one line each, within
    the launch's time limit, and no output is left."""
    d, ranks = cohort
    (rc0, out0, err0), (rc1, out1, err1) = (r["fail"][1] for r in ranks)
    assert (rc0, rc1, out0, out1) == (1, 1, "", "")
    assert err0.splitlines()[-1] == ("error: multihost operation failed on another process "
                                     "during the run sort (see that rank's error)")
    assert err1.splitlines()[-1] == "error: injected failure on rank 1"
    assert not any(p.name.startswith("fail.ibu") for p in d.iterdir())


def test_python_m_runs_the_cli(files, tmp_path):
    """``python -m ibu_tpu_torch`` is the entry point: one command in a fresh
    process prints what ``main`` prints."""
    out = subprocess.run([sys.executable, "-m", "ibu_tpu_torch", "info", files["P"]], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    info = json.loads(out.stdout)
    assert (info["records"], info["sorted"], info["bytes"]) == (5000, True, 32 + 24 * 5000)
