"""Import boundary and CPU dispatch of the torch port. This file imports no
jax, so it also runs where jax is not installed."""

import subprocess
import sys
from pathlib import Path

import numpy as np
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
