"""The port's validation matrix on the CPU: the 27 checks of
``ibu_tpu/validate.py``, named and ordered as in ``TPU_VALIDATE.json``, all
passing through the plain torch versions; and its artifact and command line.
On a card the same matrix checks the CUDA kernels (``chip_smoke.py``,
``tests/test_torch_cuda.py``)."""

import json
from pathlib import Path

import pytest
import torch

from ibu_tpu_torch import validate as V

TPU_VALIDATE = Path(__file__).resolve().parents[1] / "TPU_VALIDATE.json"


@pytest.fixture(scope="module")
def results():
    return V.run_matrix(device=torch.device("cpu"))


def test_matrix_names_and_order_match_tpu_artifact(results):
    names = list(json.loads(TPU_VALIDATE.read_text())["checks"])
    assert [name for name, _ in results] == names
    assert len(names) == 27


def test_every_check_passes_on_cpu(results):
    assert [name for name, ok in results if not ok] == []


def test_progress_lines():
    lines = []
    V.run_matrix(progress=lines.append, device="cpu")
    assert len(lines) == 27 and all(line.startswith("PASS ") for line in lines)


def test_artifact_record(tmp_path, results):
    record = V.write_artifact(tmp_path / "a" / "v.json", results, device="cpu")
    assert json.loads((tmp_path / "a" / "v.json").read_text()) == record
    assert record["backend"] == "cpu" and record["devices"] == ["cpu"]
    assert (record["passed"], record["failed"]) == (27, 0)
    assert list(record["checks"]) == [name for name, _ in results]


def test_cli_writes_under_build_and_fails_on_a_failed_check(tmp_path, monkeypatch, capsys):
    before = TPU_VALIDATE.read_bytes()
    assert V.DEFAULT_ARTIFACT.parent.name == "build"
    out = tmp_path / "v.json"
    assert V.main(["--device", "cpu", "--out", str(out)]) == 0
    printed = capsys.readouterr().out.splitlines()
    assert sum(line.startswith("PASS ") for line in printed) == 27
    assert printed[-1].startswith("27/27 checks passed on cpu")
    monkeypatch.setattr(V, "run_matrix", lambda progress, device: [("device sort", False)])
    assert V.main(["--device", "cpu", "--out", str(out)]) == 1
    assert json.loads(out.read_text())["failed"] == 1
    assert TPU_VALIDATE.read_bytes() == before
