"""The card's peak allocated memory over the window (after a reset of the peak), GiB."""


def read(run):
    return run.memory_peak_bytes / 2**30 if run.memory_peak_bytes else None
