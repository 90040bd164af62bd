"""Percent of the profiled sub-window in which no operation ran on the
device: 1 - (union of device activity) / (sub-window)."""


def read(run):
    tr = run.trace
    if not tr.window_s or tr.busy_s is None:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
