"""Device time of the image encoder (the ``sam2.encoder`` span: trunk, neck and
the high-res projections) a frame, in the frame body's replays and the eager
prompt alike, ms: the span's device ms over the frames (rows) it ran."""

from perfbench.work.spans import device_ms_per


def read(run):
    return device_ms_per(run, "sam2.encoder", "sam2.encoder", "rows")
