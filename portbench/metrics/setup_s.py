"""From the start of the process to the first timed job: torch's import,
the card, the kernels loaded (built on a checkout's first run), the inputs
and the warm-up."""


def read(run):
    return run["setup_s"]
