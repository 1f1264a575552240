"""The overflow groups the program's device histogram folded into its host
dict (its ``hist_spilled_groups`` counter: barcodes past the device table,
counted once at each merge that spilled them) per traced job. Nothing where
the program counts no such group (untraced, no barcode past the table, or a
program without the counter)."""


def read(run):
    try:
        from ibu_tpu_torch.utils.trace import session
    except ImportError:
        return None
    spans = [] if run["trace"] is None else session()
    groups = sum(s.counters.get("hist_spilled_groups", 0) for s in spans)
    jobs = len(run["window"]["job_s"])
    return groups / jobs if groups > 0 and jobs else None
