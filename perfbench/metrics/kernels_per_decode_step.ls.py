"""Device kernels launched inside one LS decode call, from the profiler
(copies and fills left out), averaged over the profiled calls."""
from perfbench.spans import is_kernel


def read(run):
    calls = [c for c in run.trace.in_window(run.timeline, "LS", "decode")
             if c.kernels is not None]
    if not calls:
        return None
    return sum(sum(is_kernel(n) for n, _ in c.kernels)
               for c in calls) / len(calls)
