"""Device time of the masks' emission (hole filling, the resize to the
video's size and the copy to the host, 16 frames at a time, and each prompted
frame's: the ``predictor.emit`` span) a request, ms."""

from perfbench.work.spans import device_ms_per


def read(run):
    return device_ms_per(run, "predictor.emit", "predictor.init_state", "count")
