"""Device time of a batch's upload and normalisation on the card (the
``serve.prepare`` span) a frame, ms: the span's device ms over the frames
(rows) it ran."""

from perfbench.work.spans import device_ms_per


def read(run):
    return device_ms_per(run, "serve.prepare", "serve.prepare", "rows")
