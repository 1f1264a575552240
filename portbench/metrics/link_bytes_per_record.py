"""Bytes the program sent over the link both ways (its ``h2d_bytes`` and
``d2h_bytes`` counters) per record of the traced jobs. A job's records are
counted once however many calls it makes over them: a roundtrip job's
encode and decode move 120 B a record at 16/12 bases. Nothing where the
program counts no such byte (untraced, on the CPU, or a program without
spans)."""


def read(run):
    try:
        from ibu_tpu_torch.utils.trace import session
    except ImportError:
        return None
    spans = [] if run["trace"] is None else session()
    moved = sum(s.counters.get(k, 0) for s in spans for k in ("h2d_bytes", "d2h_bytes"))
    records = run["window"]["records"]
    return moved / records if moved > 0 and records > 0 else None
