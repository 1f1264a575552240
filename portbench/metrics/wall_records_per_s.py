"""Records of all jobs completed in the traced window over that window's
wall time (host clock, from the first job's start to the last one's end)."""


def read(run):
    window = run["window"]
    return window["records"] / window["wall_s"] if window["wall_s"] > 0 else None
