"""Seconds from the process's start to the window's opening: imports, the
device's context, the kernels' libraries, the weights, the warm-up and the
pre-roll."""


def read(run):
    return run.setup_s
