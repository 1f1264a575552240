"""The summed time of the program's ``hist.spill`` spans (each drain of the
device histogram's overflow lane: the prefix fetch and the fold into the
host dict, after the wait for its merge) per traced job. Nothing where the
program records no such span (untraced, no barcode past the table, or a
program without the span)."""


def read(run):
    try:
        from ibu_tpu_torch.utils.trace import session
    except ImportError:
        return None
    spans = [] if run["trace"] is None else session()
    ns = [s.duration_ns for s in spans if s.name == "hist.spill"]
    jobs = len(run["window"]["job_s"])
    return sum(ns) / 1e6 / jobs if ns and jobs else None
