"""LS decode calls: each call's least time (its served rows' operations
over the peak, or every weight and the served rows' live K/V read once
over the HBM rate, whichever is longer) over its wall, synchronised at
both ends, summed over the calls. Percent."""
from perfbench import roofline


def read(run):
    calls = run.trace.in_window(run.timeline, "LS", "decode")
    wall = sum(c.t1 - c.t0 for c in calls)
    if not calls or wall <= 0:
        return None
    arch, it = run.arch["LS"], roofline.ITEMSIZE[run.dtype]
    least = sum(roofline.bound_s(roofline.decode_bytes(arch, c.starts, it),
                                 roofline.decode_flops(arch, c.starts),
                                 run.dtype) for c in calls)
    return 100.0 * least / wall
