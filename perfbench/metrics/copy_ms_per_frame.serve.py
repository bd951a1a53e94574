"""Device time of copies (memcpy and memset events, and copy and cast kernels)
in the traced window, a frame, ms."""

import re

COPY = re.compile(r"copy|Copy")


def read(run):
    if run.trace is None or not run.traced_frames:
        return None
    us = sum(v for k, v in run.trace["self_cat"].items() if k in ("gpu_memcpy", "gpu_memset"))
    us += sum(v for k, v in run.trace["self_op"].items() if COPY.search(k) and not k.startswith("Memcpy")
              and not k.startswith("Memset"))
    return us / 1e3 / run.traced_frames
