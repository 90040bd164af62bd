"""LS time to first token, 90th percentile (nearest rank), from the due
time, over the LS requests due in the window; a failed one above all."""
from perfbench.timeline import ttft_percentile_ms


def read(run):
    return ttft_percentile_ms(run.timeline, 90)
