"""Bytes of the host-to-device memcpys inside the traced jobs over their
summed device time."""

import math


def read(run):
    trace = run["trace"]
    if trace is None or trace["h2d_s"] <= 0 or math.isnan(trace["h2d_bytes"]):
        return None
    return trace["h2d_bytes"] / trace["h2d_s"] / 1e9
