"""The mean self time of the program's ``hist.update`` spans: the host's
time to issue one batch into ``DeviceHistogram``, its merges left out.
Nothing where the program records no such span (untraced, or a program
without spans)."""


def read(run):
    try:
        from ibu_tpu_torch.utils.trace import self_ns, session
    except ImportError:
        return None
    spans = [] if run["trace"] is None else session()
    ns = [t for s, t in zip(spans, self_ns(spans)) if s.name == "hist.update"]
    return sum(ns) / 1e6 / len(ns) if ns else None
