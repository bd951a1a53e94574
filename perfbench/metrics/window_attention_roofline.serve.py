"""The window-attention kernel's share of its roofline in the traced window, %."""

from perfbench.work.roofline import share


def read(run):
    return share(run, "window_attention", r"window_attention_kernel", exclude=r"qkv_window|window_attention_v1")
