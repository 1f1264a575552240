"""The summed time of the program's ``h2d.pinned_alloc`` spans (each
allocation of pinned host memory) per traced job. Nothing where the program
records no such span (untraced, on the CPU, or a program without spans)."""


def read(run):
    try:
        from ibu_tpu_torch.utils.trace import session
    except ImportError:
        return None
    spans = [] if run["trace"] is None else session()
    ns = [s.duration_ns for s in spans if s.name == "h2d.pinned_alloc"]
    jobs = len(run["window"]["job_s"])
    return sum(ns) / 1e6 / jobs if ns and jobs else None
