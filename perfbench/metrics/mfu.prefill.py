"""LS prefill calls: the model operations of their served rows (the
layers' products for every served token, attention over the visible
context, the head at each row's last position) over the calls' wall,
synchronised at both ends, over the card's bf16 peak. Percent."""
from perfbench import roofline


def read(run):
    calls = run.trace.in_window(run.timeline, "LS", "prefill")
    wall = sum(c.t1 - c.t0 for c in calls)
    if not calls or wall <= 0:
        return None
    arch = run.arch["LS"]
    flops = sum(roofline.prefill_flops(arch, c.starts, c.sq) for c in calls)
    return 100.0 * flops / wall / roofline.PEAK_FLOPS[run.dtype]
