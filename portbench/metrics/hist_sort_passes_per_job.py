"""The radix passes the program's histogram engine launched for its
group-by, per batch and per merge (its ``hist_sort_passes`` counter), per
traced job. Nothing where the program counts no such pass (untraced, on the
CPU, or a program whose histogram engine has no such counter)."""


def read(run):
    try:
        from ibu_tpu_torch.utils.trace import session
    except ImportError:
        return None
    spans = [] if run["trace"] is None else session()
    passes = sum(s.counters.get("hist_sort_passes", 0) for s in spans)
    jobs = len(run["window"]["job_s"])
    return passes / jobs if passes > 0 and jobs else None
