"""A kernel's share of its roofline, and the device's idle share, in a traced window."""

from __future__ import annotations

import re

from perfbench.work.kernels import least_seconds


def share(run, site: str, kernel_names: str, exclude: str | None = None):
    """100 x the least time of the traced requests' ``site`` calls over the
    device time of the trace's kernels whose names match ``kernel_names``
    (and not ``exclude``); None when the trace has none of them."""
    if run.trace is None or run.peak_flops is None or not run.work_per_request:
        return None
    device_us = sum(us for name, us in run.trace["self_op"].items()
                    if re.search(kernel_names, name) and not (exclude and re.search(exclude, name)))
    if device_us <= 0:
        return None
    least = least_seconds(site, run.work_per_request, run.peak_flops, run.peak_bytes_per_s) * run.traced_requests
    return 100.0 * least / (device_us / 1e6)


def idle(run):
    """100 x (1 - the device's busy time over the traced window's wall time); None untraced."""
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
