"""The roundtrip job's bytes (:data:`portbench.roofline.JOB_BYTES`) over all
kernel time inside the traced jobs, as a share of the card's peak."""

from portbench.roofline import job_share_pct


def read(run):
    return None if run["trace"] is None else job_share_pct(run["trace"], "roundtrip")
