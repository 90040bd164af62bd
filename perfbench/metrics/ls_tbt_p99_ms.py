"""LS gap between consecutive output tokens, 99th percentile (nearest
rank), over every LS gap whose later token falls in the window."""
from perfbench.timeline import ls_gaps_s, percentile


def read(run):
    v = percentile(ls_gaps_s(run.timeline), 99)
    return None if v is None else v * 1e3
