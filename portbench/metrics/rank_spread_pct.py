"""Per traced job, how far apart the ranks reach the cohort's merge: each
rank's time from its call into the program to its entry into the first
collective (its own trace, :func:`portbench.trace.collective_offsets`: the
streaming of its range, its fold and the state's copy to the host), the
slowest less the fastest, over the slowest; the median over the jobs. What
a rank then waits inside the merge is left out, so the slowest rank shows.
Nothing in a run of one rank, or where a rank's trace has no such job."""

import statistics


def read(run):
    ranks = run.get("ranks")
    if run["trace"] is None or not ranks or len(ranks) < 2:
        return None
    per_rank = [r.get("to_merge_s") or [] for r in ranks]
    if len({len(t) for t in per_rank}) != 1:
        return None
    spreads = [(max(t) - min(t)) / max(t) for t in zip(*per_rank)
               if None not in t and max(t) > 0]
    return 100.0 * statistics.median(spreads) if spreads else None
