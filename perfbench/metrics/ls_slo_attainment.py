"""Percent of the LS requests due in the window that met both of the
cell's limits: TTFT and mean time per output token (a failed one
misses)."""
from perfbench.timeline import slo_attainment


def read(run):
    lim = run.cell["limits"]
    return slo_attainment(run.timeline, lim["ttft_ms"], lim["tpot_ms"])
