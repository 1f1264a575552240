"""Bytes the program handed to its file writer (its ``written_bytes``
counter) over the summed self time of its ``file.write`` spans: the host's
rate of writing records to a file. Nothing where the program records no such
span (untraced, or a program without spans)."""


def read(run):
    try:
        from ibu_tpu_torch.utils.trace import self_ns, session
    except ImportError:
        return None
    spans = [] if run["trace"] is None else session()
    ns = sum(t for s, t in zip(spans, self_ns(spans)) if s.name == "file.write")
    written = sum(s.counters.get("written_bytes", 0) for s in spans)
    return written / ns if ns > 0 and written > 0 else None
