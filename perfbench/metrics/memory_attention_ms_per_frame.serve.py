"""Device time of memory attention over the bank (the ``sam2.memory_attention``
span) a tracked frame, inside the frame body's replays, ms: the span's device
ms over the frames (rows) it ran."""

from perfbench.work.spans import device_ms_per


def read(run):
    return device_ms_per(run, "sam2.memory_attention", "sam2.memory_attention", "rows")
