"""Device time of ``init_state`` (the clip's upload and normalisation: the
``predictor.init_state`` span) a request, ms."""

from perfbench.work.spans import device_ms_per


def read(run):
    return device_ms_per(run, "predictor.init_state", "predictor.init_state", "count")
