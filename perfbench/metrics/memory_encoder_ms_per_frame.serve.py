"""Device time of the memory encoder and its bank write (the
``sam2.memory_encoder`` span) a frame, in the replays and the eager prompt
alike, ms: the span's device ms over the frames (rows) it ran."""

from perfbench.work.spans import device_ms_per


def read(run):
    return device_ms_per(run, "sam2.memory_encoder", "sam2.memory_encoder", "rows")
