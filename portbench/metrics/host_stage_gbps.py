"""Bytes the program copied into pinned staging buffers (its ``staged_bytes``
counter) over the summed self time of its ``h2d.stage`` spans: the host's
copy rate on the way to the card. Nothing where the program records no such
span (untraced, on the CPU, or a program without spans)."""


def read(run):
    try:
        from ibu_tpu_torch.utils.trace import self_ns, session
    except ImportError:
        return None
    spans = [] if run["trace"] is None else session()
    ns = sum(t for s, t in zip(spans, self_ns(spans)) if s.name == "h2d.stage")
    staged = sum(s.counters.get("staged_bytes", 0) for s in spans)
    return staged / ns if ns > 0 and staged > 0 else None
