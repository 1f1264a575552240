"""The port's executable docstring examples: the counterparts of the nine
modules of ``tests/test_doctests.py``, each with examples that run
(``attempted > 0``) and pass."""

import ast
import doctest
from pathlib import Path

import pytest

import ibu_tpu_torch.constructs.header
import ibu_tpu_torch.constructs.record
import ibu_tpu_torch.io.compression
import ibu_tpu_torch.io.mmap
import ibu_tpu_torch.io.reader
import ibu_tpu_torch.io.writer
import ibu_tpu_torch.ops.codec
import ibu_tpu_torch.ops.u64
import ibu_tpu_torch.parallel.processor

MODULES = [
    ibu_tpu_torch.constructs.header,
    ibu_tpu_torch.constructs.record,
    ibu_tpu_torch.io.compression,
    ibu_tpu_torch.io.mmap,
    ibu_tpu_torch.io.reader,
    ibu_tpu_torch.io.writer,
    ibu_tpu_torch.ops.codec,
    ibu_tpu_torch.ops.u64,
    ibu_tpu_torch.parallel.processor,
]


def test_the_modules_are_the_references_nine():
    """The modules ``tests/test_doctests.py`` imports, under the port's name."""
    source = (Path(__file__).parent / "test_doctests.py").read_text()
    ref = {alias.name for node in ast.walk(ast.parse(source)) if isinstance(node, ast.Import)
           for alias in node.names if alias.name.startswith("ibu_tpu.")}
    assert len(ref) == 9
    assert {m.__name__.replace("ibu_tpu_torch.", "ibu_tpu.", 1) for m in MODULES} == ref


@pytest.mark.parametrize("module", MODULES, ids=lambda m: m.__name__)
def test_module_doctests(module):
    results = doctest.testmod(module, verbose=False)
    assert results.failed == 0, f"{results.failed} doctest failures in {module}"
    assert results.attempted > 0
