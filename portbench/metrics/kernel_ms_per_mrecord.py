"""The card's kernel time over the whole window of an untraced run (the union
of every kernel on any stream; no memcpy or memset) per million records of
the jobs completed in it."""


def read(run):
    card, records = run.get("card"), run["window"]["records"]
    if card is None or card["kernel_s"] <= 0 or records <= 0:
        return None
    return card["kernel_s"] * 1e3 / (records / 1e6)
