"""The 95th percentile (nearest rank) of every request's wall time in the window."""

import math


def read(run):
    if not run.request_ms:
        return None
    ms = sorted(run.request_ms)
    return ms[math.ceil(0.95 * len(ms)) - 1]
