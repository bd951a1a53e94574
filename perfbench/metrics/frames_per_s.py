"""Frames whose masks reached the host, over the window's wall time."""


def read(run):
    return run.frames / run.window_s if run.window_s > 0 and run.frames else None
