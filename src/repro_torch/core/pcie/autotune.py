"""cfs_period auto-tuner (§6.3): as cfs_period grows, per-DMA-call overhead
amortizes and throughput converges to the bus peak. The tuner binary-searches
the minimum cfs_period whose saturated throughput reaches (1-eps) of the
converged value — small periods keep LS responsiveness, large ones keep
throughput; we want the knee."""
from __future__ import annotations

from .bus import BusSpec, PACKET, closed_loop_requests, summarize
from .cfs import PCIeCFS


def saturated_throughput(period: int, bus: BusSpec, horizon: float = 0.2,
                         n_tenants: int = 2) -> float:
    reqs = []
    for k in range(n_tenants):
        reqs += closed_loop_requests(f"be{k}", nice=1, size=40 << 20,
                                     direction="h2d", horizon=horizon,
                                     est_rate=bus.bw_h2d / n_tenants,
                                     start_rid=10_000_000 * (k + 1))
    comps = PCIeCFS(cfs_period=period).run(reqs, bus, "h2d")
    comps = [c for c in comps if c.t_done <= horizon]
    if not comps:
        return 0.0
    t_end = max(c.t_done for c in comps)
    return sum(c.req.size for c in comps) / max(t_end, 1e-9)


def autotune_cfs_period(bus: BusSpec, eps: float = 0.02,
                        lo: int = 16, hi: int = 65536) -> int:
    peak = saturated_throughput(hi, bus)
    target = (1.0 - eps) * peak
    while lo < hi:
        mid = (lo + hi) // 2
        if saturated_throughput(mid, bus) >= target:
            hi = mid
        else:
            lo = mid + 1
    return lo
