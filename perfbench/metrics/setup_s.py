"""Set-up: from the process's start to the window's (imports, the kernel
library's load or build, weights, inputs, the warm-up and its capture)."""


def read(run):
    return run.setup_s
