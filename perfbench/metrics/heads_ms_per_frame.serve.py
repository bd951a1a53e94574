"""Device time of the prompt encoder and mask decoder (the ``sam2.heads`` span) a
frame, in the replays and the eager prompt alike, ms: the span's device ms
over the frames (rows) it ran."""

from perfbench.work.spans import device_ms_per


def read(run):
    return device_ms_per(run, "sam2.heads", "sam2.heads", "rows")
