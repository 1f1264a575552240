"""The share of the traced jobs' wall that the host spent blocked on the
card: the program's ``d2h.wait`` spans (a fetch) and ``stream.slot_wait``
spans (a staging buffer's earlier copy). Nothing where the program records
no such span (untraced, on the CPU, or a program without spans)."""

WAITS = ("d2h.wait", "stream.slot_wait")


def read(run):
    try:
        from ibu_tpu_torch.utils.trace import session
    except ImportError:
        return None
    trace = run["trace"]
    spans = [] if trace is None else session()
    ns = [s.duration_ns for s in spans if s.name in WAITS]
    if not ns or trace["jobs_s"] <= 0:
        return None
    return 100.0 * sum(ns) / 1e9 / trace["jobs_s"]
