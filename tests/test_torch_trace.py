"""The port's tracer (:mod:`ibu_tpu_torch.utils.trace`): off without a
profiler, the five entry points recorded as roots under one, sessions, and
the spans on the exported Chrome trace's clock.

The ``cuda`` cases skip where no card is present; the file imports no jax,
so on a machine with a card it runs alone:

    python -m pytest tests/test_torch_trace.py -q --noconftest
"""

import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ibu_tpu_torch import Header, MmapReader, Writer, make_records
from ibu_tpu_torch import pipelines as TPL
from ibu_tpu_torch.parallel.device import stream_file_histogram
from ibu_tpu_torch.utils import trace

REPO = Path(__file__).resolve().parents[1]
N = 20000
BC_LEN, UMI_LEN = 12, 8


def _rows(n, L, seed):
    rng = np.random.default_rng(seed)
    return np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (n, L))]


def _records(n, seed=3):
    rng = np.random.default_rng(seed)
    return make_records(rng.integers(0, 1 << (2 * BC_LEN), n, dtype=np.uint64),
                        rng.integers(0, 1 << (2 * UMI_LEN), n, dtype=np.uint64),
                        rng.permutation(n).astype(np.uint64))


@pytest.fixture(scope="module")
def ibu_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("trace") / "r.ibu")
    with Writer.from_path(path, Header.new(BC_LEN, UMI_LEN)) as w:
        w.write_batch(_records(N))
    return path


#: each entry point as a benchmark cell calls it, on the CPU
ROOTS = {
    "ibu.encode_batch": lambda path: TPL.encode_batch(
        _rows(N, BC_LEN, 1), _rows(N, UMI_LEN, 2), np.arange(N, dtype=np.uint64),
        engine="device", device="cpu"),
    "ibu.decode_batch": lambda path: TPL.decode_batch(
        _records(N), BC_LEN, UMI_LEN, engine="device", device="cpu"),
    "ibu.sort_batch": lambda path: TPL.sort_batch(
        _records(N), BC_LEN, UMI_LEN, index_bits=32, device="cpu"),
    "ibu.file_stats": lambda path: TPL.file_stats(path, engine="device", device="cpu"),
    "ibu.stream_file_histogram": lambda path: stream_file_histogram(
        MmapReader(path), "cpu", batch_records=4096, max_uniques_per_shard=8192),
}


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_off_without_a_profiler_records_nothing():
    before = trace.session()
    span = trace.span("ibu.encode_batch")
    assert span is trace.OFF and trace.span("other") is span
    with span:
        trace.count("records", 5)
    assert trace.session() == before


@pytest.mark.parametrize("root", sorted(ROOTS))
def test_each_entry_point_is_a_root_with_its_records(root, ibu_file):
    trace.session()  # read with the profiler off: the next root starts a session
    with _cpu_profile():
        ROOTS[root](ibu_file)
    spans = trace.session()
    assert spans[0].name == root and spans[0].parent is None and spans[0].index == 0
    assert [s.name for s in spans if s.parent is None] == [root]
    assert spans[0].counters["records"] == N
    for s in spans:
        assert s.root == 0 and s.thread == spans[0].thread and s.end_ns >= s.start_ns
        if s.parent is not None:
            p = spans[s.parent]
            assert p.index < s.index and p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    if root == "ibu.stream_file_histogram":
        names = {s.name for s in spans}
        assert {"stream.hint", "hist.update", "hist.merge", "hist.finalize"} <= names
        merges = [s for s in spans if s.name == "hist.merge"]
        assert all(spans[m.parent].name in ("hist.update", "hist.finalize") for m in merges)


def test_a_second_profiler_session_starts_a_new_session(ibu_file):
    trace.session()
    with _cpu_profile():
        ROOTS["ibu.file_stats"](ibu_file)
        ROOTS["ibu.sort_batch"](ibu_file)
    first = trace.session()
    assert [s.name for s in first if s.parent is None] == ["ibu.file_stats", "ibu.sort_batch"]
    ROOTS["ibu.sort_batch"](ibu_file)  # untraced: finds the profiler off
    with _cpu_profile():
        ROOTS["ibu.decode_batch"](ibu_file)
        assert [s.name for s in trace.session()] == ["ibu.decode_batch"]
    assert [s.name for s in trace.session()] == ["ibu.decode_batch"]
    assert [s.name for s in first if s.parent is None] == ["ibu.file_stats", "ibu.sort_batch"]


def test_spans_match_their_chrome_trace_events(ibu_file, tmp_path):
    trace.session()
    with _cpu_profile() as prof:
        with record_function("caller"):
            ROOTS["ibu.stream_file_histogram"](ibu_file)
            ROOTS["ibu.file_stats"](ibu_file)
    spans = trace.session()
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base_us = doc["baseTimeNanoseconds"] / 1000
    events = [e for e in doc["traceEvents"] if e.get("ph") == "X"
              and e.get("cat") == "user_annotation"]
    caller = next(e for e in events if e["name"] == "caller")
    c0, c1 = caller["ts"] + base_us, caller["ts"] + caller["dur"] + base_us
    by_name: dict[str, list] = {}
    for e in sorted(events, key=lambda e: e["ts"]):
        by_name.setdefault(e["name"], []).append(e)
    assert len(spans) > 5
    for s in spans:
        own = by_name[s.name].pop(0)
        t0, t1 = own["ts"] + base_us, own["ts"] + own["dur"] + base_us
        assert abs(s.start_ns / 1000 - t0) < 1000 and abs(s.end_ns / 1000 - t1) < 1000
        assert c0 <= s.start_ns / 1000 and s.end_ns / 1000 <= c1
    assert all(not left for name, left in by_name.items() if name.startswith(("ibu.", "hist.")))


def test_counters_land_on_the_innermost_span_and_self_time_leaves_out_children():
    trace.session()
    with _cpu_profile():
        with trace.span("outer"):
            trace.count("bytes", 3)
            with trace.span("inner"):
                trace.count("bytes", 4)
                trace.count("bytes", 1)
            with trace.span("inner"):
                pass
            trace.count("bytes", 2)
    trace.count("bytes", 100)  # outside every span and off: nowhere
    outer, a, b = trace.session()
    assert (outer.counters, a.counters, b.counters) == ({"bytes": 5}, {"bytes": 5}, {})
    assert (a.parent, b.parent, a.root, b.root) == (0, 0, 0, 0)
    own = trace.self_ns([outer, a, b])
    assert own[0] == outer.duration_ns - a.duration_ns - b.duration_ns
    assert own[1:] == [a.duration_ns, b.duration_ns]


def test_a_span_on_another_thread_is_its_own_root():
    trace.session()
    with _cpu_profile():
        with trace.span("main"):
            done = []

            def side():
                with trace.span("side"):
                    done.append(threading.get_ident())

            worker = threading.Thread(target=side)
            worker.start()
            worker.join(timeout=30)
    assert not worker.is_alive() and done
    spans = {s.name: s for s in trace.session()}
    assert spans["side"].parent is None and spans["side"].root == spans["side"].index
    assert spans["side"].thread == done[0] != spans["main"].thread


def test_importing_the_tracer_loads_no_torch():
    code = ("import sys\n"
            "from ibu_tpu_torch.utils import trace\n"
            "with trace.span('x'):\n"
            "    trace.count('n', 1)\n"
            "print(trace.session(), 'torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] False"


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _moved(spans, key):
    return sum(s.counters.get(key, 0) for s in spans)


@pytest.mark.cuda
def test_encode_then_decode_moves_120_bytes_a_record(card):
    n = 1 << 16
    bc, umi, idx = _rows(n, 16, 1), _rows(n, 12, 2), np.arange(n, dtype=np.uint64)
    TPL.encode_batch(bc, umi, idx, engine="device", device=card)  # the kernels load
    trace.session()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        records = TPL.encode_batch(bc, umi, idx, engine="device", device=card)
        out = TPL.decode_batch(records, 16, 12, engine="device", device=card)
    spans = trace.session()
    assert np.array_equal(out[0], bc) and np.array_equal(out[1], umi)
    assert [s.name for s in spans if s.parent is None] == ["ibu.encode_batch", "ibu.decode_batch"]
    assert _moved(spans, "h2d_bytes") == n * (16 + 12 + 8 + 24)
    assert _moved(spans, "d2h_bytes") == n * (24 + 16 + 12 + 8)
    assert (_moved(spans, "h2d_bytes") + _moved(spans, "d2h_bytes")) / n == 120.0
    assert _moved(spans, "staged_bytes") == bc.nbytes + umi.nbytes + idx.nbytes + records.nbytes
    stages = [s for s in spans if s.name == "h2d.stage"]
    assert [s.counters["staged_bytes"] for s in stages] == [bc.nbytes, umi.nbytes, idx.nbytes,
                                                           records.nbytes]
    assert sum(s.name == "d2h.wait" for s in spans) == 4
    assert sum(s.name == "h2d.pinned_alloc" for s in spans) == 8


@pytest.mark.cuda
def test_the_stream_stages_each_batch_once_and_counts_its_bytes(card, ibu_file):
    trace.session()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        stats = TPL.file_stats(ibu_file, engine="device", device=card)
    spans = trace.session()
    assert stats["count"] == N
    assert _moved(spans, "staged_bytes") == _moved(spans, "h2d_bytes") == N * 24
    assert _moved(spans, "d2h_bytes") == 8 + 24  # the count and the three sums
