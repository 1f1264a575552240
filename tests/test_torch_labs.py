"""The codec labs of the torch port against the TPU labs' own kernels, on the CPU.

``tools/sol_lab.py`` and ``tools/kernel_lab.py`` are imported by path, and the
``pl`` module each resolves is replaced by a stand-in whose ``pallas_call``
runs the kernel in interpret mode and keeps each call's outputs, so the
encode kernel's ``(6, N)`` or ``(8, N)`` column matrix and the decode kernel's
planes are both seen. The same seeded numpy inputs go through them and through
the port's plain versions (and its wrappers, which run the plain versions for
CPU tensors); records cross through ``records_from_jax_soa``. Where a TPU
variant computes the codec, the port must agree exactly. The floor modes are
the port's own, so they are held exactly to the numpy statement of what the
port writes (:mod:`ibu_tpu_torch.labs._harness`).
"""

import ast
import importlib.util
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ibu_tpu_torch.labs import _harness as H
from ibu_tpu_torch.labs import _kernels as K
from ibu_tpu_torch.labs import kernel_lab, sol_lab
from ibu_tpu_torch.ops.codec import np_pack, np_unpack
from ibu_tpu_torch.ops.u64 import records_from_jax_soa

REPO = Path(__file__).resolve().parents[1]
N = 2048  # tools/kernel_lab.py::check_correct reads the first 2048 records
TILE = 512
CPU = torch.device("cpu")

#: tools/sol_lab.py's registry: name → make_plane's (enc, dec) or make_packed's sol
TPU_VARIANTS = {
    "prod": ("real", "real"),
    "sol_touch": ("touch", "touch"),
    "sol_reduce": ("reduce", "reduce"),
    "enc_only": ("real", "touch"),
    "dec_only": ("touch", "real"),
    "nib": ("real", "nib"),
    "tree": ("tree", "nib"),
    "tree_only": ("tree", "touch"),
    "nib_only": ("touch", "nib"),
    "lut8": ("real", "lut8"),
    "lut16": ("real", "lut16"),
    "e8": ("real8", "real"),
    "e16": ("real16", "real"),
    "e16lut16": ("real16", "lut16"),
    "e8lut8": ("real8", "lut8"),
    "mxu": ("mxu", "real"),
    "mxu_only": ("mxu", "touch"),
    "packed": False,
    "packed_sol": True,
}
TPU_FLOORS = ("touch", "reduce")


def load_tpu_lab(name):
    spec = importlib.util.spec_from_file_location(f"_tpu_{name}", REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Interpret:
    """Stands in for the ``pl`` module a TPU lab resolves: ``pallas_call``
    runs in interpret mode and keeps each call's outputs in ``outputs``."""

    def __init__(self):
        self.outputs = []

    def __getattr__(self, name):
        return getattr(pl, name)

    def pallas_call(self, *args, **kwargs):
        call = pl.pallas_call(*args, **{**kwargs, "interpret": True})

        def run(*operands):
            out = call(*operands)
            self.outputs.append(out)
            return out

        return run


@pytest.fixture(scope="module")
def tpu_sol():
    return load_tpu_lab("sol_lab")


@pytest.fixture(scope="module")
def tpu_kernel():
    return load_tpu_lab("kernel_lab")


def interpreted(module, monkeypatch) -> Interpret:
    shim = Interpret()
    monkeypatch.setattr(module, "pl", shim)
    return shim


def random_rows(n, length, seed, alphabet=b"ACGTacgt"):
    rng = np.random.default_rng(seed)
    return np.frombuffer(alphabet, np.uint8)[rng.integers(0, len(alphabet), (n, length))]


def random_index(n, seed):
    return np.random.default_rng(seed).integers(0, 1 << 64, n, dtype=np.uint64)


def pair(idx):
    """u64 indices → the TPU labs' ``(2, N)`` uint32 [lo, hi] pair."""
    return jnp.asarray(np.stack([idx & 0xFFFFFFFF, idx >> np.uint64(32)]).astype(np.uint32))


def t(arr):
    return torch.from_numpy(np.ascontiguousarray(arr))


def planes_to_rows(planes):
    return np.ascontiguousarray(np.asarray(planes).T)


def lab_inputs(seed):
    """Lab-formula rows of input set ``seed % 3`` and random mixed-case rows,
    stacked, with full-range indices."""
    bc = np.concatenate([H.host_rows(N // 2, 16, 0, seed % 3), random_rows(N // 2, 16, seed)])
    umi = np.concatenate([H.host_rows(N // 2, 12, 16, seed % 3), random_rows(N // 2, 12, seed + 1)])
    return bc, umi, random_index(N, seed + 2)


# ---------------------------------------------------------------------------
# the registry and the accounting
# ---------------------------------------------------------------------------


def tpu_registry_source() -> dict:
    """``tools/sol_lab.py``'s ``variants`` dict, read from its source:
    name → make_plane's (enc, dec), or make_packed's ``sol``."""
    tree = ast.parse((REPO / "tools" / "sol_lab.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "variants":
            out = {}
            for key, value in zip(node.value.keys, node.value.values):
                call = value.elts[0]
                if call.func.id == "make_plane":
                    out[key.value] = tuple(a.value for a in call.args[1:])
                else:
                    out[key.value] = call.keywords[0].value.value
            return out
    raise AssertionError("no variants dict in tools/sol_lab.py")


def test_registry_answers_every_tpu_variant_name():
    registry = tpu_registry_source()
    assert registry == TPU_VARIANTS
    assert set(sol_lab.JAX_NAMES) == set(registry)
    assert set(sol_lab.JAX_NAMES.values()) == set(sol_lab.VARIANTS)
    for name in registry:
        assert sol_lab.resolve(name) in sol_lab.VARIANTS
    with pytest.raises(ValueError, match="unknown variant"):
        sol_lab.resolve("e4")


def test_useful_bytes_match_the_tpu_labs(tpu_sol, tpu_kernel):
    assert H.USEFUL_BYTES == tpu_kernel.USEFUL_BYTES == tpu_sol.USEFUL_BYTES == 120
    assert kernel_lab.moved_bytes(("sep", 3, "sep")) == H.USEFUL_BYTES
    assert kernel_lab.moved_bytes(("comb", 4, "comb")) == 144


def test_inputs_follow_the_tpu_formula(tpu_sol, tpu_kernel):
    n = 1024
    first = H.make_inputs(n, 0, CPU)
    bc, umi, bcp, umip, idx = (np.asarray(a) for a in tpu_sol.make_inputs(n))
    assert np.array_equal(first["bc"].numpy(), bc.T) and np.array_equal(first["umi"].numpy(), umi.T)
    assert np.array_equal(first["bcp"].numpy().view(np.uint32), bcp.T)
    assert np.array_equal(first["umip"].numpy().view(np.uint32), umip.T)
    assert np.array_equal(first["index"].numpy(), idx[0].astype(np.int64))
    comb = np.asarray(tpu_kernel.make_inputs(n)[0])
    assert np.array_equal(first["comb"].numpy()[:, :28], comb[:28].T)
    assert bool((first["comb"][:, 28:] == ord("A")).all())
    sets = H.make_sets(n, CPU)
    assert len(sets) == 3
    assert not any(torch.equal(a["bc"], b["bc"]) for i, a in enumerate(sets) for b in sets[i + 1:])


# ---------------------------------------------------------------------------
# sol_lab: every TPU variant against the port
# ---------------------------------------------------------------------------


def check_encode(enc, tpu_soa, bc, umi, idx):
    """The port's encode ``enc`` against the TPU kernel's column matrix (a
    codec mode) or the numpy statement (a floor)."""
    got = K.plain_sol_encode(t(bc), t(umi), t(idx.view(np.int64)), enc)
    assert torch.equal(K.sol_encode(t(bc), t(umi), t(idx.view(np.int64)), enc), got)
    if enc in K.CODEC_ENC:
        assert torch.equal(got, records_from_jax_soa(np.asarray(tpu_soa)))
    else:
        assert np.array_equal(got[:, :2].numpy().view(np.uint64), H.np_encode(enc, bc, umi))
        assert np.array_equal(got[:, 2].numpy().view(np.uint64), idx)


def check_decode(dec, records, tpu_out):
    """The port's decode ``dec`` of ``records`` against the TPU kernel's
    planes (a codec mode) or the numpy statement (a floor)."""
    got = K.plain_sol_decode(records, dec)
    assert all(torch.equal(a, b) for a, b in zip(K.sol_decode(records, dec), got))
    if dec in K.CODEC_DEC:
        want = (planes_to_rows(tpu_out[0]), planes_to_rows(tpu_out[1]))
    else:
        want = H.np_decode(dec, records[:, :2].numpy().view(np.uint64))
    assert np.array_equal(got[0].numpy(), want[0]) and np.array_equal(got[1].numpy(), want[1])
    assert torch.equal(got[2], records[:, 2])


@pytest.mark.parametrize("name", [n for n, v in TPU_VARIANTS.items() if isinstance(v, tuple)])
def test_plane_variant_matches_tpu_lab(name, tpu_sol, monkeypatch):
    shim = interpreted(tpu_sol, monkeypatch)
    enc, dec, layout = sol_lab.VARIANTS[sol_lab.JAX_NAMES[name]]
    assert layout == "sep"
    bc, umi, idx = lab_inputs(seed=sum(map(ord, name)))
    tpu_enc, tpu_dec = TPU_VARIANTS[name]
    roundtrip = tpu_sol.make_plane(TILE, tpu_enc, tpu_dec)
    roundtrip((jnp.asarray(bc.T), jnp.asarray(umi.T), pair(idx)), jnp.uint32(0))
    tpu_soa, tpu_out = shim.outputs
    assert (enc in K.CODEC_ENC) == (tpu_enc not in TPU_FLOORS)
    assert (dec in K.CODEC_DEC) == (tpu_dec not in TPU_FLOORS)
    check_encode(enc, tpu_soa, bc, umi, idx)
    # both decoders read the TPU encode's words, codec or floor
    records = records_from_jax_soa(np.asarray(tpu_soa))
    check_decode(dec, records, tpu_out)
    if dec in K.CODEC_DEC:
        assert np.array_equal(np.asarray(tpu_out[2]), np.asarray(tpu_soa)[4:6])


@pytest.mark.parametrize("sol", [False, True])
def test_packed_variant_matches_tpu_lab(sol, tpu_sol, monkeypatch):
    shim = interpreted(tpu_sol, monkeypatch)
    bc, umi, idx = lab_inputs(seed=31 + sol)
    bcp, umip = bc.view("<i4"), umi.view("<i4")
    tpu_sol.make_packed(TILE, sol)(
        (jnp.asarray(bcp.T.view(np.uint32)), jnp.asarray(umip.T.view(np.uint32)), pair(idx)),
        jnp.uint32(0))
    tpu_soa, tpu_out = shim.outputs
    args = (t(bcp), t(umip), t(idx.view(np.int64)))
    got = K.plain_packed_encode(*args, sol)
    assert torch.equal(K.packed_encode(*args, sol), got)
    records = records_from_jax_soa(np.asarray(tpu_soa))
    decoded = K.plain_packed_decode(records, sol)
    assert all(torch.equal(a, b) for a, b in zip(K.packed_decode(records, sol), decoded))
    if sol:
        assert np.array_equal(got[:, :2].numpy().view(np.uint64), H.np_encode("touch", bc, umi))
        want = H.np_decode("touch", records[:, :2].numpy().view(np.uint64))
        assert np.array_equal(decoded[0].numpy(), want[0].view("<i4"))
        assert np.array_equal(decoded[1].numpy(), want[1].view("<i4"))
    else:
        assert torch.equal(got, records)
        assert np.array_equal(decoded[0].numpy().view(np.uint32), planes_to_rows(tpu_out[0]))
        assert np.array_equal(decoded[1].numpy().view(np.uint32), planes_to_rows(tpu_out[1]))
        tpu_sol.check_packed_soa(TILE, *(tpu_sol.make_inputs(N)[i] for i in (2, 3, 4)))
    assert torch.equal(decoded[2], records[:, 2])


# ---------------------------------------------------------------------------
# kernel_lab: the 8 layouts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("combo", kernel_lab.COMBOS, ids=kernel_lab.combo_name)
def test_layout_matches_tpu_lab(combo, tpu_kernel, monkeypatch):
    enc_in, cols, dec_out = combo
    shim = interpreted(tpu_kernel, monkeypatch)
    bc, umi, idx = lab_inputs(seed=cols * 10 + len(enc_in) + len(dec_out))
    junk = random_rows(N, 4, seed=5, alphabet=bytes(range(256)))  # bases 28-31: ignored
    comb = np.concatenate([bc, umi, junk], axis=1)
    roundtrip = tpu_kernel.make_roundtrip(enc_in, 6 if cols == 3 else 8, dec_out, TILE)
    roundtrip(jnp.asarray(comb.T), jnp.asarray(bc.T), jnp.asarray(umi.T), pair(idx), jnp.uint32(0))
    tpu_soa, tpu_out = (np.asarray(shim.outputs[0]), shim.outputs[1])
    rows = (t(bc), t(umi)) if enc_in == "sep" else (t(comb),)
    got = K.plain_layout_encode(rows, t(idx.view(np.int64)), cols)
    assert torch.equal(K.layout_encode(rows, t(idx.view(np.int64)), cols), got)
    assert got.shape == (N, cols)
    assert torch.equal(got[:, :3], records_from_jax_soa(tpu_soa[:6]))
    if cols == 4:
        assert not tpu_soa[6:].any() and not got[:, 3].any()
    records = t(np.ascontiguousarray(tpu_soa.T).view(np.int64))  # (N, cols)
    decoded = K.plain_layout_decode(records, dec_out == "comb")
    assert all(torch.equal(a, b) for a, b in zip(K.layout_decode(records, dec_out == "comb"), decoded))
    want_rows = [planes_to_rows(p) for p in tpu_out[:-1]]
    assert len(decoded) == len(tpu_out)
    for a, b in zip(decoded[:-1], want_rows):
        assert np.array_equal(a.numpy(), b)
    assert np.array_equal(decoded[-1].numpy().view(np.uint64), idx)
    # the TPU lab's own check, on its own inputs
    tpu_kernel.check_correct(roundtrip, *tpu_kernel.make_inputs(N))


# ---------------------------------------------------------------------------
# the port's modes on their own
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", K.ENC_MODES)
def test_encode_modes_on_every_byte(mode):
    """The codec is total and the floors see raw bytes: every mode on all 256
    byte values against the host oracle."""
    bc, umi = random_rows(999, 16, 7, bytes(range(256))), random_rows(999, 12, 8, bytes(range(256)))
    idx = random_index(999, 9)
    got = K.sol_encode(t(bc), t(umi), t(idx.view(np.int64)), mode)
    assert np.array_equal(got[:, :2].numpy().view(np.uint64), H.np_encode(mode, bc, umi))
    assert np.array_equal(got[:, 2].numpy().view(np.uint64), idx)
    if mode in K.CODEC_ENC:
        assert np.array_equal(got[:, 0].numpy().view(np.uint64), np_pack(bc))


@pytest.mark.parametrize("mode", K.DEC_MODES)
def test_decode_modes_on_any_words(mode):
    words = np.random.default_rng(10).integers(0, 1 << 64, (999, 3), dtype=np.uint64)
    bc, umi, idx = K.sol_decode(t(words.view(np.int64)), mode)
    want_bc, want_umi = H.np_decode(mode, words[:, :2])
    assert np.array_equal(bc.numpy(), want_bc) and np.array_equal(umi.numpy(), want_umi)
    assert np.array_equal(idx.numpy().view(np.uint64), words[:, 2])
    if mode in K.CODEC_DEC:
        assert np.array_equal(bc.numpy(), np_unpack(words[:, 0], 16))


@pytest.mark.parametrize("offset", [1, 4])
def test_plain_versions_take_row_views_at_any_offset(offset):
    """Contiguous row views that start 1 or 4 bytes into a buffer, as the card
    tests feed the kernels: the plain versions read the same bytes."""
    n = 257
    buf = t(random_rows(1, 32 * n + 16, 11, bytes(range(256)))[0])
    bc, umi = buf[offset:offset + 16 * n].view(n, 16), buf[offset:offset + 12 * n].view(n, 12)
    idx = t(random_index(n, 12).view(np.int64))
    for mode in K.ENC_MODES:
        got = K.sol_encode(bc, umi, idx, mode)
        assert np.array_equal(got[:, :2].numpy().view(np.uint64),
                              H.np_encode(mode, bc.numpy(), umi.numpy()))
    comb = buf[offset:offset + 32 * n].view(n, 32)
    got = K.layout_encode((comb,), idx, 4).numpy().view(np.uint64)
    assert np.array_equal(got[:, 0], np_pack(np.ascontiguousarray(comb.numpy()[:, :16])))
    assert np.array_equal(got[:, 1], np_pack(np.ascontiguousarray(comb.numpy()[:, 16:28])))
    words = t(random_index(3 * n + 1, 13).view(np.int64))[1:].view(n, 3)  # 8 bytes in
    for mode in K.DEC_MODES:
        got = K.sol_decode(words, mode)
        want = H.np_decode(mode, words[:, :2].numpy().view(np.uint64))
        assert np.array_equal(got[0].numpy(), want[0]) and np.array_equal(got[1].numpy(), want[1])
    bcp, umip, _ = K.packed_decode(words)
    assert np.array_equal(bcp.numpy().view(np.uint8), np_unpack(words[:, 0].numpy().view(np.uint64), 16))
    fields = torch.tensor([(1 << 32) - 1, (1 << 24) - 1])  # the bits 16 and 12 bases hold
    assert torch.equal(K.packed_encode(bcp, umip, idx)[:, :2], words[:, :2] & fields)


def test_wrappers_reject_bad_inputs():
    bc, umi = torch.zeros((4, 16), dtype=torch.uint8), torch.zeros((4, 12), dtype=torch.uint8)
    idx = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="unknown encode mode"):
        K.sol_encode(bc, umi, idx, "mxu")
    with pytest.raises(ValueError, match="unknown decode mode"):
        K.sol_decode(torch.zeros((4, 3), dtype=torch.int64), "lut8")
    with pytest.raises(ValueError, match="block 100"):
        K.sol_encode(bc, umi, idx, block=100)
    with pytest.raises(ValueError, match=r"\(N, 12\)"):
        K.sol_encode(bc, bc, idx)
    with pytest.raises(ValueError, match="holds 3 records"):
        K.sol_encode(bc, umi[:3], idx)
    with pytest.raises(ValueError, match="contiguous"):
        K.layout_encode((torch.zeros((32, 4), dtype=torch.uint8).t(),), idx)
    with pytest.raises(ValueError, match="int32"):
        K.packed_encode(bc[:, :4], umi[:, :3].contiguous(), idx)
    with pytest.raises(ValueError, match=r"\(N, 3\) or \(N, 4\)"):
        K.layout_decode(torch.zeros((4, 5), dtype=torch.int64))
    with pytest.raises(ValueError, match="3 or 4"):
        K.layout_encode((bc, umi), idx, records=6)


# ---------------------------------------------------------------------------
# the command lines and the timing code
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lab", [sol_lab, kernel_lab], ids=["sol_lab", "kernel_lab"])
def test_main_refuses_without_a_card(lab, capsys):
    assert not torch.cuda.is_available()
    assert lab.main(["--records", "64"]) == 2
    out = capsys.readouterr().out
    assert "no CUDA card" in out and "GB/s" not in out
    assert lab.main(["--records", "64", "--device", "cuda"]) == 2


@pytest.mark.parametrize("lab,extra", [(sol_lab, ["--variants", "lut8,mxu,packed_sol"]),
                                       (kernel_lab, ["--blocks", "128,512"])],
                         ids=["sol_lab", "kernel_lab"])
def test_main_runs_the_checks_on_cpu(lab, extra, capsys):
    assert lab.main(["--device", "cpu", "--records", "1000", *extra]) == 0
    out = capsys.readouterr().out
    assert "no timing" in out and "FAILED" not in out and "GB/s" not in out
    assert out.count("oracle-exact") == (3 if lab is sol_lab else 16)


def test_a_failed_check_ends_the_run_nonzero(monkeypatch, capsys):
    plain = K.plain_sol_decode

    def broken(records, mode="nib"):
        bc, umi, idx = plain(records, mode)
        return (bc ^ 1, umi, idx) if mode == "lut" else (bc, umi, idx)

    monkeypatch.setattr(K, "plain_sol_decode", broken)
    assert sol_lab.main(["--device", "cpu", "--records", "500", "--variants", "prod,lut"]) == 1
    out = capsys.readouterr().out
    assert "lut: FAILED the oracle check (barcode rows differ)" in out
    assert "prod: oracle-exact" in out and "1 variant(s) failed: lut" in out
    monkeypatch.setattr(K, "plain_layout_encode", lambda rows, index, records=3: torch.zeros(
        (index.shape[0], records), dtype=torch.int64))
    assert kernel_lab.main(["--device", "cpu", "--records", "500", "--blocks", "256",
                            "--variants", "sep3sep"]) == 1
    assert "sep3sep/b256: FAILED" in capsys.readouterr().out


def test_module_entry_points():
    for lab in ("sol_lab", "kernel_lab"):
        cmd = [sys.executable, "-m", f"ibu_tpu_torch.labs.{lab}", "--records", "256"]
        assert subprocess.run(cmd, cwd=REPO, capture_output=True, timeout=120).returncode == 2
        run = subprocess.run(cmd + ["--device", "cpu"], cwd=REPO, capture_output=True, text=True,
                             timeout=120)
        assert run.returncode == 0, run.stdout + run.stderr
        assert "no timing" in run.stdout


class FakeEvent:
    """A CUDA event stand-in on the host clock, to drive the timing code."""

    clock = 0.0

    def __init__(self, enable_timing=True):
        self.at = None

    def record(self):
        FakeEvent.clock += 1.0
        self.at = FakeEvent.clock

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.at - self.at


def test_timing_and_tables_with_stub_events(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    sets = H.make_sets(300, CPU)
    rows, halves = sol_lab.time_all(sets, ["prod", "lut"], runs=2)
    assert [r.name for r in rows] == ["sol_touch", "prod", "lut"]
    assert [r.name for r in halves] == ["encode touch", "encode real", "encode_records",
                                        "decode touch", "decode nib", "decode_records"]
    assert all(r.ms > 0 and r.ms_min <= r.ms for r in rows + halves)
    lines = sol_lab.report(rows, halves)
    assert lines[0].split()[:4] == ["variant", "ms", "ms", "min"]
    assert lines[1].startswith("sol_touch") and " 100.0 " in lines[1]
    assert any(line.startswith("copy floor (sol_touch)") for line in lines)
    assert halves[0].as_dict(halves[0].ms)["gbps"] == pytest.approx(300 * 60 / (halves[0].ms * 1e6))
    layout = kernel_lab.time_all(sets, blocks=(256,), runs=1)
    assert [r.name for r in layout[:3]] == ["sol_touch", "production", "sep3sep/b256"]
    assert len(layout) == 2 + len(kernel_lab.COMBOS)
    assert {r.name: r.moved for r in layout}["comb4comb/b256"] == 144
