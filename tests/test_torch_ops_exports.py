"""``ibu_tpu_torch.ops``'s exports and ``__version__`` against ``ibu_tpu``'s:
the thirteen names with counterparts resolve, the other eleven are absent by
name, and importing the package alone loads no torch."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import ibu_tpu
import ibu_tpu.ops
import ibu_tpu_torch
import ibu_tpu_torch.ops

REPO = Path(__file__).resolve().parents[1]
#: name → the port module that defines it (a submodule name: the module itself)
EXPORTS = {
    "codec": "codec", "stats": "stats", "u64": "u64",
    **dict.fromkeys(("encode_seqs", "decode_seqs", "np_pack", "np_unpack", "seqs_to_rows",
                     "rows_to_seqs"), "codec"),
    **dict.fromkeys(("encode_records", "decode_records", "encode_planes", "decode_planes"),
                    "codec_cuda"),
}
#: the reference's names that serve the TPU's layouts, absent by decision
ABSENT = {"codec_pallas", "lax_encode_planes", "lax_decode_planes", "rows_to_planes",
          "planes_to_rows", "pair_to_words", "words_to_pair", "split_u64", "join_u64",
          "soa_from_records", "records_from_soa"}


def test_all_is_the_thirteen_names():
    assert sorted(ibu_tpu_torch.ops.__all__) == sorted(EXPORTS)
    assert len(ibu_tpu_torch.ops.__all__) == 13


@pytest.mark.parametrize("name", sorted(EXPORTS))
def test_each_name_resolves_to_its_module(name):
    import importlib

    module = importlib.import_module(f"ibu_tpu_torch.ops.{EXPORTS[name]}")
    got = getattr(ibu_tpu_torch.ops, name)
    assert got is (module if name == EXPORTS[name] else getattr(module, name))


def test_the_missing_names_are_the_eleven_by_decision():
    assert set(ibu_tpu.ops.__all__) - set(ibu_tpu_torch.ops.__all__) == ABSENT
    assert set(ibu_tpu_torch.ops.__all__) <= set(ibu_tpu.ops.__all__)
    for name in ABSENT:
        assert not hasattr(ibu_tpu_torch.ops, name)
    with pytest.raises(ImportError):
        exec("from ibu_tpu_torch.ops import codec_pallas", {})


def test_from_import_works():
    from ibu_tpu_torch.ops import decode_records, encode_seqs, stats

    assert callable(encode_seqs) and callable(decode_records)
    assert stats.sort_records.__module__ == "ibu_tpu_torch.ops.stats"


def test_encode_seqs_equals_the_reference():
    from ibu_tpu.ops import decode_seqs as j_decode
    from ibu_tpu.ops import encode_seqs as j_encode
    from ibu_tpu_torch.ops import decode_seqs, encode_seqs

    rng = np.random.default_rng(11)
    seqs = ["".join("ACGTacgt"[c] for c in rng.integers(0, 8, 1 + i % 32)) for i in range(300)]
    for length in (16, 32):
        batch = [s.ljust(length, "A")[:length] for s in seqs]
        words = encode_seqs(batch)
        assert words.dtype == np.uint64
        assert np.array_equal(words, j_encode(batch))
        assert decode_seqs(words, length) == j_decode(words, length)


def test_version_equals_the_reference():
    assert ibu_tpu_torch.__version__ == ibu_tpu.__version__ == "0.1.0"


def test_importing_ops_alone_loads_no_torch():
    code = (
        "import sys\n"
        "import ibu_tpu_torch.ops\n"
        "from ibu_tpu_torch.ops import encode_seqs, np_pack, codec\n"
        "assert encode_seqs(['ACGT']).tolist() == [228]\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'ibu_tpu'))\n"
        "print('loaded', bad)\n"
        "from ibu_tpu_torch.ops import stats\n"
        "print('torch' in sys.modules)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == ["loaded []", "True"]
