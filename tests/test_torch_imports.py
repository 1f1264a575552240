"""Import boundary and CPU dispatch of the torch port. This file imports no
jax, so it also runs where jax is not installed."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ibu_tpu_torch.labs import _kernels as LK
from ibu_tpu_torch.ops import codec_cuda as K

REPO = Path(__file__).resolve().parents[1]


def test_port_loads_no_jax():
    code = (
        "import sys\n"
        "import ibu_tpu_torch, ibu_tpu_torch.pipelines, ibu_tpu_torch.io.stream\n"
        "import ibu_tpu_torch.parallel.device, ibu_tpu_torch.ops.codec_cuda\n"
        "import ibu_tpu_torch.validate, ibu_tpu_torch.ops.stats\n"
        "import ibu_tpu_torch.labs.sol_lab, ibu_tpu_torch.labs.kernel_lab\n"
        "import ibu_tpu_torch.labs.sort_lab, ibu_tpu_torch.native\n"
        "import ibu_tpu_torch.ops.knee, ibu_tpu_torch.ops.correct\n"
        "import ibu_tpu_torch.examples.workflow\n"
        "import ibu_tpu_torch.parallel.select, ibu_tpu_torch.parallel.host\n"
        "import ibu_tpu_torch.examples.fastq_ingest, ibu_tpu_torch.examples.roundtrip\n"
        "import ibu_tpu_torch.__main__, ibu_tpu_torch.parallel.processor\n"
        "import ibu_tpu_torch.examples.random, ibu_tpu_torch.examples.parallel\n"
        "import ibu_tpu_torch.parallel.multihost, ibu_tpu_torch.parallel.sort\n"
        "import ibu_tpu_torch.data, ibu_tpu_torch.entry\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


PORT_SOURCES = sorted((REPO / "ibu_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path):
    """Top-level package of every import statement in ``path``."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_scan_covers_the_fastq_slice():
    scanned = {str(p.relative_to(REPO)) for p in PORT_SOURCES}
    for name in ("parallel/select.py", "parallel/host.py", "examples/fastq_ingest.py",
                 "examples/roundtrip.py", "native.py", "pipelines.py"):
        assert f"ibu_tpu_torch/{name}" in scanned


CLI_MODULES = ("__main__.py", "parallel/processor.py", "examples/random.py",
             "examples/parallel.py")


def test_the_scans_cover_the_cli_modules():
    scanned = {str(p.relative_to(REPO)) for p in PORT_SOURCES}
    for name in CLI_MODULES:
        assert f"ibu_tpu_torch/{name}" in scanned


COHORT_MODULES = ("parallel/multihost.py", "parallel/sort.py", "data.py")


def test_the_scans_cover_the_cohort_modules():
    scanned = {str(p.relative_to(REPO)) for p in PORT_SOURCES}
    for name in COHORT_MODULES:
        assert f"ibu_tpu_torch/{name}" in scanned


def test_the_scans_cover_the_entry_module():
    """``ibu_tpu_torch/entry.py`` (the entry points) is in the AST
    scan; both fresh-process tests import it."""
    scanned = {str(p.relative_to(REPO)) for p in PORT_SOURCES}
    assert "ibu_tpu_torch/entry.py" in scanned


LAB_MODULES = ("engine_capacity_lab", "histogram_capacity_lab", "molcount_capacity_lab",
               "sort_keys_lab", "stream_lab", "put_sweep", "put_source_lab")


def test_the_scans_cover_the_capacity_and_feed_labs():
    scanned = {str(p.relative_to(REPO)) for p in PORT_SOURCES}
    for name in LAB_MODULES + ("_capacity",):
        assert f"ibu_tpu_torch/labs/{name}.py" in scanned
    assert "ibu_tpu_torch/utils/datagen.py" in scanned


def test_capacity_and_feed_labs_load_neither_ibu_tpu_nor_jax():
    """The seven labs and the generator in a fresh process; the generator
    alone loads no torch either."""
    code = (
        "import importlib, sys\n"
        "import ibu_tpu_torch.utils.datagen\n"
        "assert 'torch' not in sys.modules, 'datagen loads torch'\n"
        f"for name in {LAB_MODULES!r}:\n"
        "    importlib.import_module('ibu_tpu_torch.labs.' + name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('ibu_tpu', 'jax', 'jaxlib'))\n"
        "print('loaded', bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "loaded []"


def test_host_commands_load_no_jax_torch_or_cuda(tmp_path):
    """``python -m ibu_tpu_torch info`` in a fresh process, then the other
    host commands and the host engines of ``count``, ``dedup`` and ``stats``
    in the same process: they print what they should and load neither the
    JAX package nor torch, so no CUDA library is mapped and no CUDA context
    is made."""
    from ibu_tpu_torch import Header, Writer, make_records

    path = str(tmp_path / "i.ibu")
    header = Header.new(16, 12)
    header.set_sorted()
    with Writer.from_path(path, header) as w:
        w.write_batch(make_records(np.arange(10), np.arange(10), np.arange(10)))
    (tmp_path / "allow.txt").write_text("3\n")
    commands = [
        ["info", path], ["check", path], ["sort", path, "s.ibu"], ["split", path, "p{}.ibu", "2"],
        ["merge", "m.ibu", "p0.ibu", "p1.ibu"], ["concat", "c.ibu", "p0.ibu", "p1.ibu"],
        ["filter", path, "f.ibu", "--barcodes", "allow.txt"], ["lookup", path, "3"],
        ["subsample", path, "u.ibu", "--n", "4"], ["repair", path, "r.ibu"],
        # device commands whose engine runs on the host
        ["count", path, "m"], ["dedup", path, "d.ibu"], ["stats", path, "--engine", "native"],
    ]
    code = (
        "import runpy, sys\n"
        f"for argv in {commands!r}:\n"
        "    sys.argv = ['ibu_tpu_torch', *argv]\n"
        "    try:\n"
        "        runpy.run_module('ibu_tpu_torch', run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, (argv, e.code)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('ibu_tpu', 'jax', 'jaxlib', 'torch'))\n"
        "maps = open('/proc/self/maps').read()\n"
        "cuda = sorted({l.split()[-1] for l in maps.splitlines() if 'libcuda' in l})\n"
        "print('loaded', bad, cuda)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert '"records": 10' in lines[0] and lines[-1] == "loaded [] []"
    assert "OK" in lines and "merged 2 sorted files -> m.ibu" in lines
    assert (tmp_path / "m.ibu").read_bytes() == (tmp_path / "s.ibu").read_bytes()


@pytest.mark.parametrize("path", PORT_SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_source_imports_neither_ibu_tpu_nor_jax(path):
    bad = [name for name in _imported_roots(path)
           if name.split(".")[0] in ("ibu_tpu", "jax", "jaxlib")]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_every_port_module_loads_without_ibu_tpu_or_jax():
    """Import every module of the package (and ``chip_smoke``) in a fresh
    process; neither ``ibu_tpu`` nor ``jax`` may be loaded after."""
    modules = ["chip_smoke"] + [
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in sorted((REPO / "ibu_tpu_torch").rglob("*.py"))
    ]
    assert "ibu_tpu_torch.labs.sort_lab" in modules
    for name in ("ibu_tpu_torch.ops.knee", "ibu_tpu_torch.ops.correct",
                 "ibu_tpu_torch.examples", "ibu_tpu_torch.examples.workflow",
                 "ibu_tpu_torch.parallel.select", "ibu_tpu_torch.parallel.host",
                 "ibu_tpu_torch.examples.fastq_ingest", "ibu_tpu_torch.examples.roundtrip",
                 *(f"ibu_tpu_torch.{n.removesuffix('.py').replace('/', '.')}"
                   for n in CLI_MODULES + COHORT_MODULES)):
        assert name in modules
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('ibu_tpu', 'jax', 'jaxlib'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_no_jax_import_in_port_sources():
    for path in (REPO / "ibu_tpu_torch").rglob("*.py"):
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path


def test_cpu_tensors_run_plain_versions_without_launching(monkeypatch):
    for kernel in (K.encode_records, K.decode_records, K.encode_planes, K.decode_planes):
        monkeypatch.setattr(kernel, "launches", 0)
    rng = np.random.default_rng(0)
    bc = torch.from_numpy(np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (50, 16))])
    umi = torch.from_numpy(np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (50, 12))])
    idx = torch.arange(50, dtype=torch.int64)
    records = K.encode_records(bc, umi, idx)
    assert torch.equal(records, K.plain_encode_records(bc, umi, idx))
    out = K.decode_records(records, 16, 12)
    assert all(torch.equal(a, b) for a, b in zip(out, (bc, umi, idx)))
    assert torch.equal(K.decode_planes(K.encode_planes(bc), 16), bc)
    launches = (K.encode_records, K.decode_records, K.encode_planes, K.decode_planes)
    assert [k.launches for k in launches] == [0, 0, 0, 0]


def test_cpu_tensors_launch_no_lab_kernel(monkeypatch):
    for kernel, _, _ in LK.KERNELS.values():
        monkeypatch.setattr(kernel, "launches", 0)
    rng = np.random.default_rng(1)
    bc = torch.from_numpy(np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (50, 16))])
    umi = torch.from_numpy(np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (50, 12))])
    idx = torch.arange(50, dtype=torch.int64)
    for mode in LK.ENC_MODES:
        records = LK.sol_encode(bc, umi, idx, mode)
    for mode in LK.DEC_MODES:
        LK.sol_decode(records, mode)
    bcp, umip = bc.view(torch.int32), umi.view(torch.int32)
    for sol in (False, True):
        LK.packed_decode(LK.packed_encode(bcp, umip, idx, sol), sol)
    comb = torch.cat([bc, umi, torch.full((50, 4), 65, dtype=torch.uint8)], dim=1)
    for rows in ((bc, umi), (comb,)):
        for cols in (3, 4):
            for out in (LK.layout_decode(LK.layout_encode(rows, idx, cols), False),
                        LK.layout_decode(LK.layout_encode(rows, idx, cols), True)):
                assert torch.equal(out[0][:, :16], bc)
    assert {name: k.launches for name, (k, _, _) in LK.KERNELS.items()} == dict.fromkeys(LK.KERNELS, 0)
