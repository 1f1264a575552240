"""Engine auto-selection of the port, ``ibu_tpu_torch.parallel.select``,
against ``ibu_tpu.parallel.select``.

The decision function is pure and the probes take injected clocks, so the
logic is tested with fake timers and injected rates, with no hardware. The
texts (reasons, stderr lines) are compared character for character, the
decisions for equality (tolerance 0); with ``device="cpu"`` the port must
answer what the JAX package answers on its CPU backend.
"""

import numpy as np
import pytest
import torch

from ibu_tpu import Header, Writer
from ibu_tpu import pipelines as JPL
from ibu_tpu.constructs.record import make_records
from ibu_tpu.parallel import select as JS
from ibu_tpu_torch import native as TN
from ibu_tpu_torch import pipelines as TPL
from ibu_tpu_torch.parallel import select as TS

CUDA0 = torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    monkeypatch.delenv("IBU_AUTO_ENGINE", raising=False)
    JS.reset_probe_memo()
    TS.reset_probe_memo()
    yield
    JS.reset_probe_memo()
    TS.reset_probe_memo()


@pytest.fixture
def a_card(monkeypatch):
    """Let the port resolve every device to a CUDA card, so the probing
    branch runs here; the probes themselves are injected."""
    monkeypatch.setattr(TS, "resolve_device", lambda device=None: CUDA0)

    def no_probe(*a, **k):
        raise AssertionError("a real feed probe ran")

    monkeypatch.setattr(TS, "measure_device_feed_gbps", no_probe)


@pytest.fixture
def as_tpu(monkeypatch):
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")


@pytest.fixture()
def small_file(tmp_path):
    rng = np.random.default_rng(3)
    n = 20_000
    recs = make_records(
        rng.integers(0, 1 << 20, n).astype(np.uint64),
        rng.integers(0, 1 << 24, n).astype(np.uint64),
        np.arange(n, dtype=np.uint64),
    )
    path = tmp_path / "sel.ibu"
    with Writer.from_path(str(path), Header.new(16, 12)) as w:
        w.write_batch(recs)
    return str(path), recs


def test_the_names_and_constants_are_the_reference_s():
    names = ["PROBE_BYTES", "PROBE_RECORDS", "CODEC_BYTES_PER_RECORD", "measure_device_feed_gbps",
             "measure_native_recs_per_s", "host_numpy_recs_per_s", "probe_rates",
             "reset_probe_memo", "choose_stats_engine", "auto_stats_engine",
             "measure_native_codec_recs", "numpy_codec_recs_per_s", "auto_codec_engine",
             "measure_host_histogram_recs", "auto_device_or_host"]
    for name in names:
        assert hasattr(TS, name), name
    for const in ("PROBE_BYTES", "PROBE_RECORDS", "CODEC_BYTES_PER_RECORD"):
        assert getattr(TS, const) == getattr(JS, const)
    assert TS.host_numpy_recs_per_s() == JS.host_numpy_recs_per_s() == 40e6
    assert TS.numpy_codec_recs_per_s() == JS.numpy_codec_recs_per_s() == 5e6


DECISIONS = [
    (0.041, 516e6, 1.0, "native"),
    (8.0, 300e6, 1.0, "device"),
    (0.041, None, 1.0, "host"),
    (8.0, None, 1.0, "device"),
    (2.4, 100e6, 1.0, "device"),
    (2.4, 100e6, 1.5, "native"),
    (25.0, 1.2e9, 1.0, "native"),
    (55.0, 1.2e9, 1.0, "device"),
]


@pytest.mark.parametrize("gbps,native_recs,margin,want", DECISIONS)
def test_choose_stats_engine_matches_jax(gbps, native_recs, margin, want):
    got = TS.choose_stats_engine(gbps, native_recs, margin)
    assert got == JS.choose_stats_engine(gbps, native_recs, margin)
    assert got[0] == want


class TestProbesFakeClock:
    def test_device_feed_fake_timer(self):
        # scripted clock: every timed put appears to take exactly 1 s
        times = iter([float(i) for i in range(100)])
        gbps = TS.measure_device_feed_gbps(
            device="cpu", probe_bytes=1 << 20, timer=lambda: next(times), min_seconds=0.05)
        # one put satisfies min_seconds at the fake 1 s per put
        rows = (1 << 20) // 24
        assert gbps == pytest.approx(rows * 24 / 1e9)

    def test_device_feed_stops_at_max_puts(self):
        ticks = iter(np.arange(0, 100, 0.001).tolist())
        calls = []

        def timer():
            calls.append(1)
            return next(ticks)

        gbps = TS.measure_device_feed_gbps(device="cpu", probe_bytes=2400, timer=timer,
                                           min_seconds=10.0, max_puts=3)
        assert len(calls) == 6  # two readings per put, three puts
        assert gbps == pytest.approx(3 * 2400 / 0.003 / 1e9)

    def test_device_feed_needs_a_device(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            TS.measure_device_feed_gbps()

    def test_device_feed_goes_through_to_device(self, monkeypatch):
        sent = []
        real = TS.to_device
        monkeypatch.setattr(TS, "to_device", lambda arr, dev: sent.append(arr.shape) or real(arr, dev))
        TS.measure_device_feed_gbps(device="cpu", probe_bytes=2400, max_puts=2, min_seconds=1e9)
        assert sent == [(1, 3), (100, 3), (100, 3)]

    def test_native_probe_fake_timer(self, small_file):
        if not TN.available():
            pytest.skip("no native runtime on this box")
        path, recs = small_file
        times = iter([0.0, 2.0])
        rate = TS.measure_native_recs_per_s(
            path, len(recs), probe_records=1 << 20, timer=lambda: next(times))
        assert rate == pytest.approx(len(recs) / 2.0)

    def test_native_probe_none_when_empty_or_unavailable(self, tmp_path, small_file, monkeypatch):
        p = tmp_path / "e.ibu"
        with Writer.from_path(str(p), Header.new(16, 12)):
            pass
        assert TS.measure_native_recs_per_s(str(p), 0) is None
        monkeypatch.setattr(TN, "available", lambda: False)
        assert TS.measure_native_recs_per_s(small_file[0], 20_000) is None
        assert TS.measure_native_codec_recs() is None

    def test_codec_and_histogram_probes_fake_timer(self):
        if TN.available():
            times = iter([0.0, 0.5])
            assert TS.measure_native_codec_recs(probe_rows=1 << 16, timer=lambda: next(times)) \
                == pytest.approx((1 << 16) / 0.5)
        times = iter([1.0, 1.25])
        assert TS.measure_host_histogram_recs(probe_records=1 << 12, timer=lambda: next(times)) \
            == pytest.approx((1 << 12) / 0.25)


class TestMemoAndOverride:
    def test_probe_rates_memoized(self, small_file, monkeypatch):
        path, recs = small_file
        calls = {"dev": 0, "nat": 0}

        def fake_dev(device=None):
            calls["dev"] += 1
            return 5.0

        def fake_nat(p, n):
            calls["nat"] += 1
            return 4e8

        monkeypatch.setattr(TS, "measure_device_feed_gbps", fake_dev)
        monkeypatch.setattr(TS, "measure_native_recs_per_s", fake_nat)
        r1 = TS.probe_rates(path, len(recs), device="cpu")
        r2 = TS.probe_rates(path, len(recs), device="cpu")
        assert r1 == r2 == {"device_gbps": 5.0, "native_recs": 4e8}
        assert calls == {"dev": 1, "nat": 1}
        TS.reset_probe_memo()
        TS.probe_rates(path, len(recs), device="cpu")
        assert calls == {"dev": 2, "nat": 2}

    def test_probe_memo_not_poisoned_by_empty_file(self, tmp_path, small_file):
        if not TN.available():
            pytest.skip("no native runtime")
        empty = tmp_path / "e.ibu"
        with Writer.from_path(str(empty), Header.new(16, 12)):
            pass
        r1 = TS.probe_rates(str(empty), 0, device="cpu")
        assert r1["native_recs"] is None  # nothing to probe this call
        r2 = TS.probe_rates(small_file[0], 20_000, device="cpu")
        assert r2["native_recs"] is not None and r2["native_recs"] > 0

    def test_no_native_is_cached_as_none(self, small_file, monkeypatch):
        monkeypatch.setattr(TN, "available", lambda: False)
        monkeypatch.setattr(TS, "measure_device_feed_gbps", lambda device=None: 1.0)
        assert TS.probe_rates(small_file[0], 20_000, device="cpu") == {
            "device_gbps": 1.0, "native_recs": None}
        assert TS._MEMO == {"device_gbps": 1.0, "native_recs": None}

    @pytest.mark.parametrize("env,stats,binary", [
        ("host", "host", "host"), ("native", "native", "host"), ("device", "device", "device")])
    def test_env_override_skips_probes_and_device_lookup(self, small_file, monkeypatch,
                                                         env, stats, binary):
        path, recs = small_file

        def boom(*a, **k):
            raise AssertionError("ran despite IBU_AUTO_ENGINE")

        monkeypatch.setattr(TS, "probe_rates", boom)
        monkeypatch.setattr(TS, "resolve_device", boom)
        monkeypatch.setattr(JS, "probe_rates", boom)
        monkeypatch.setenv("IBU_AUTO_ENGINE", env)
        assert TS.auto_stats_engine(path, len(recs)) == JS.auto_stats_engine(path, len(recs)) \
            == stats
        assert TS.auto_device_or_host() == JS.auto_device_or_host() == binary
        assert TS.auto_codec_engine() == JS.auto_codec_engine() == binary

    @pytest.mark.parametrize("rates", [{"device_gbps": 0.04, "native_recs": 5e8},
                                       {"device_gbps": 30.0, "native_recs": 5e8},
                                       {"device_gbps": 0.5, "native_recs": None}])
    def test_stats_announcement_is_the_reference_s(self, small_file, monkeypatch, capsys, rates):
        path, recs = small_file
        monkeypatch.setattr(JS, "probe_rates", lambda *a, **k: dict(rates))
        monkeypatch.setattr(TS, "probe_rates", lambda *a, **k: dict(rates))
        want = JS.auto_stats_engine(path, len(recs))
        want_err = capsys.readouterr().err
        got = TS.auto_stats_engine(path, len(recs), device="cpu")
        got_err = capsys.readouterr().err
        assert got == want and got_err == want_err
        assert got_err.startswith("engine auto: device feed ") and f"-> {got} " in got_err
        assert TS.auto_stats_engine(path, len(recs), device="cpu", announce=False) == want
        assert capsys.readouterr().err == ""


class TestNoCard:
    """``"auto"`` never turns "no card" into "host" silently."""

    @pytest.fixture(autouse=True)
    def no_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

        def boom(*a, **k):
            raise AssertionError("a probe ran before the device was resolved")

        for name in ("measure_device_feed_gbps", "measure_native_recs_per_s",
                     "measure_native_codec_recs", "measure_host_histogram_recs"):
            monkeypatch.setattr(TS, name, boom)

    def test_every_auto_function_raises_before_any_probe(self, small_file):
        path, recs = small_file
        for call in (lambda: TS.auto_codec_engine(), lambda: TS.auto_device_or_host(),
                     lambda: TS.auto_stats_engine(path, len(recs)),
                     lambda: TS.auto_codec_engine(device="cuda")):
            with pytest.raises(RuntimeError, match='device="cpu"'):
                call()
        assert TS._MEMO == {}

    def test_a_cpu_verdict_in_the_memo_does_not_hide_the_card(self):
        assert TS.auto_codec_engine(device="cpu", announce=False) in ("host", "device")
        with pytest.raises(RuntimeError, match="no CUDA card is available"):
            TS.auto_codec_engine()

    def test_the_entry_points_raise_with_the_auto_default(self, small_file):
        path, recs = small_file
        rows = np.full((4, 16), ord("A"), np.uint8)
        for call in (lambda: TPL.encode_batch(rows, rows[:, :12], np.arange(4, dtype=np.uint64)),
                     lambda: TPL.decode_batch(recs[:4], 16, 12),
                     lambda: TPL.file_stats(path)):
            with pytest.raises(RuntimeError, match='device="cpu"'):
                call()

    def test_the_override_needs_no_card_for_a_host_engine(self, small_file, monkeypatch):
        path, recs = small_file
        monkeypatch.setenv("IBU_AUTO_ENGINE", "host")
        assert TPL.file_stats(path)["engine"] == "host"
        bc, umi, idx = TPL.decode_batch(recs[:9], 16, 12)
        assert TPL.encode_batch(bc, umi, idx).tobytes() == recs[:9].tobytes()


class TestCpuCarveOuts:
    @pytest.mark.parametrize("have_native", [True, False])
    def test_codec_on_the_cpu_matches_jax(self, monkeypatch, capsys, have_native):
        from ibu_tpu import native as JN

        if have_native and not (TN.available() and JN.available()):
            pytest.skip("no native runtime")
        if not have_native:
            monkeypatch.setattr(TN, "available", lambda: False)
            monkeypatch.setattr(JN, "available", lambda: False)
        want = JS.auto_codec_engine()
        want_err = capsys.readouterr().err
        got = TS.auto_codec_engine(device="cpu")
        assert got == want == ("host" if have_native else "device")
        assert capsys.readouterr().err == want_err
        assert want_err == f"codec engine auto: cpu backend -> {want} (IBU_AUTO_ENGINE overrides)\n"
        # memoized: decided and announced once
        assert TS.auto_codec_engine(device="cpu") == want and capsys.readouterr().err == ""

    def test_histogram_on_the_cpu_matches_jax(self, capsys):
        want = JS.auto_device_or_host(what="histogram")
        want_err = capsys.readouterr().err
        assert TS.auto_device_or_host(device="cpu", what="histogram") == want == "host"
        assert capsys.readouterr().err == want_err
        assert TS.auto_device_or_host(device="cpu", announce=False) == "host"
        assert capsys.readouterr().err == ""


CODEC_RATES = [(0.03, 110e6, "host"), (8.0, 110e6, "device"), (0.03, None, "host"),
               (1.0, None, "device"), (25.0, 400e6, "host"), (26.0, 400e6, "device")]


class TestOnACard:
    """The probing branch, with a stand-in card and injected rates, against
    the JAX package told it runs on an accelerator."""

    @pytest.mark.parametrize("gbps,codec_recs,want", CODEC_RATES)
    def test_codec_decision_and_text_match_jax(self, a_card, as_tpu, capsys, gbps, codec_recs,
                                               want):
        memo = {"device_gbps": gbps, "native_codec_recs": codec_recs}
        JS._MEMO.update(memo)
        TS._MEMO.update(memo)
        j = JS.auto_codec_engine()
        j_err = capsys.readouterr().err
        t = TS.auto_codec_engine()
        t_err = capsys.readouterr().err
        assert t == j == want and t_err == j_err
        assert t_err.startswith("codec engine auto: device link ~")
        assert TS._MEMO["codec_engine"] == want
        assert TS.auto_codec_engine() == want and capsys.readouterr().err == ""

    def test_codec_probes_once_and_memoizes(self, a_card, monkeypatch):
        calls = []
        monkeypatch.setattr(TS, "measure_device_feed_gbps",
                            lambda device=None: calls.append(device) or 50.0)
        monkeypatch.setattr(TS, "measure_native_codec_recs", lambda: calls.append("codec") or 1e8)
        assert TS.auto_codec_engine(announce=False) == "device"
        assert TS.auto_codec_engine(announce=False) == "device"
        assert calls == [CUDA0, "codec"]
        assert TS._MEMO["device_gbps"] == 50.0 and TS._MEMO["native_codec_recs"] == 1e8

    @pytest.mark.parametrize("gbps,want", [(10.0, "device"), (0.04, "host")])
    def test_histogram_uses_the_host_histogram_bar(self, a_card, as_tpu, capsys, gbps, want):
        # a feed faster than np.unique but slower than the checksum engine
        # must pick the device
        memo = {"device_gbps": gbps, "host_hist_recs": 90e6, "native_recs": 900e6}
        JS._MEMO.update(memo)
        TS._MEMO.update(memo)
        j = JS.auto_device_or_host(what="histogram")
        j_err = capsys.readouterr().err
        assert TS.auto_device_or_host(what="histogram") == j == want
        assert capsys.readouterr().err == j_err

    def test_stats_probe_gets_the_resolved_device(self, a_card, small_file, monkeypatch):
        path, recs = small_file
        seen = []
        monkeypatch.setattr(TS, "measure_device_feed_gbps",
                            lambda device=None: seen.append(device) or 100.0)
        monkeypatch.setattr(TS, "measure_native_recs_per_s", lambda p, n: 1e8)
        assert TS.auto_stats_engine(path, len(recs), announce=False) == "device"
        assert seen == [CUDA0]


class TestAutoDefaults:
    def test_defaults_are_the_reference_s(self):
        import inspect

        for name in ("encode_batch", "decode_batch", "file_stats", "barcode_counts",
                     "call_cells", "count_matrix"):
            want = inspect.signature(getattr(JPL, name)).parameters["engine"].default
            got = inspect.signature(getattr(TPL, name)).parameters["engine"].default
            assert got == want, name
        assert inspect.signature(TPL.file_stats).parameters["engine"].default == "auto"

    def test_file_stats_auto_agrees_with_every_engine(self, small_file, monkeypatch, capsys):
        path, recs = small_file
        want = {k: v for k, v in JPL.file_stats(path, engine="host").items() if k != "engine"}
        auto = TPL.file_stats(path, device="cpu")
        assert "engine auto: device feed" in capsys.readouterr().err
        assert auto["engine"] in ("device", "native", "host")
        assert {k: v for k, v in auto.items() if k != "engine"} == want
        for engine in ("host", "native", "device"):
            if engine == "native" and not TN.available():
                continue
            monkeypatch.setenv("IBU_AUTO_ENGINE", engine)
            assert TPL.file_stats(path, device="cpu") == {**want, "engine": engine}
            assert TPL.file_stats(path, device="cpu") == JPL.file_stats(path)

    def test_unknown_engine_text_is_the_reference_s(self, small_file):
        path, _ = small_file
        with pytest.raises(ValueError) as j:
            JPL.file_stats(path, engine="quantum")
        with pytest.raises(ValueError) as t:
            TPL.file_stats(path, engine="quantum", device="cpu")
        assert str(t.value) == str(j.value) == "engine must be auto/device/native/host, got 'quantum'"

    def test_an_override_naming_no_engine_is_refused_like_jax(self, small_file, monkeypatch):
        path, _ = small_file
        monkeypatch.setenv("IBU_AUTO_ENGINE", "quantum")
        with pytest.raises(ValueError) as j:
            JPL.file_stats(path)
        with pytest.raises(ValueError) as t:
            TPL.file_stats(path, device="cpu")
        assert str(t.value) == str(j.value)

    @pytest.mark.parametrize("env", [None, "device", "host"])
    def test_codec_forks_are_identical_and_match_jax(self, monkeypatch, env):
        if env:
            monkeypatch.setenv("IBU_AUTO_ENGINE", env)
        rng = np.random.default_rng(8)
        n = 5_000
        al = np.frombuffer(b"ACGT", dtype=np.uint8)
        bc, umi = al[rng.integers(0, 4, (n, 16))], al[rng.integers(0, 4, (n, 12))]
        idx = rng.integers(0, 1 << 60, n, dtype=np.uint64)
        got = TPL.encode_batch(bc, umi, idx, device="cpu")
        assert got.tobytes() == JPL.encode_batch(bc, umi, idx).tobytes()
        for a, b in zip(TPL.decode_batch(got, 16, 12, device="cpu"),
                        JPL.decode_batch(got, 16, 12)):
            assert a.dtype == b.dtype and np.array_equal(a, b)

    def test_column_slices_of_one_array_encode_like_copies(self):
        # ingest hands encode_batch two column slices of one (N, 28) array
        rng = np.random.default_rng(9)
        prefixes = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (3000, 28))]
        idx = np.arange(3000, dtype=np.uint64)
        for engine in ("device", "host"):
            got = TPL.encode_batch(prefixes[:, :16], prefixes[:, 16:], idx, engine=engine,
                                   device="cpu")
            want = TPL.encode_batch(prefixes[:, :16].copy(), prefixes[:, 16:].copy(), idx,
                                    engine=engine, device="cpu")
            assert got.tobytes() == want.tobytes()
