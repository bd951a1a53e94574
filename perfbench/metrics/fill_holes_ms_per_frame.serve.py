"""Device time of hole filling over a batch's frames (the ``serve.fill_holes``
span) a frame, ms: the span's device ms over the frames (rows) it ran."""

from perfbench.work.spans import device_ms_per


def read(run):
    return device_ms_per(run, "serve.fill_holes", "serve.fill_holes", "rows")
