"""1 - the device's busy time over the traced window's wall time, %."""

from perfbench.work.roofline import idle


def read(run):
    return idle(run)
