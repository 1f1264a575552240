"""The share of the traced jobs' wall in which no kernel, memcpy or memset
runs on the card; nothing where the trace holds no device
operation at all."""


def read(run):
    trace = run["trace"]
    if trace is None or trace["jobs_s"] <= 0 or trace["busy_in_jobs_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_in_jobs_s"] / trace["jobs_s"])
