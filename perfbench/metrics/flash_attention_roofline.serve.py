"""The flash kernel's (its key-split pass and its combine) share of its roofline in the traced window, %."""

from perfbench.work.roofline import share


def read(run):
    return share(run, "flash_attention", r"flash_fwd_kernel|flash_combine_kernel")
