"""The stats fold's bytes (:data:`portbench.roofline.JOB_BYTES`) over all
kernel time inside the traced jobs, as a share of the card's peak: the
stream_stats job's, or one rank's of the cohort_stats job (rank 0's trace
over rank 0's range)."""

from portbench.roofline import job_share_pct

#: the jobs whose kernels are the stats fold
FOLD_JOBS = ("stream_stats", "cohort_stats")


def read(run):
    trace = run["trace"]
    if trace is None or trace["job"] not in FOLD_JOBS:
        return None
    return job_share_pct(trace, trace["job"])
