"""Import boundary and CPU dispatch of the torch port. This file imports no
jax, so it also runs where jax is not installed."""

import ast
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
                 "ibu_tpu_torch.examples.fastq_ingest", "ibu_tpu_torch.examples.roundtrip"):
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
