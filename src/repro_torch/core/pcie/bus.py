"""Host<->device interconnect model + copy-request/workload types.

The bus is transport-agnostic (PCIe 3.0x16 on the paper's servers; PCIe/DCN on
TPU hosts): full-duplex, fixed per-direction bandwidth, a fixed per-DMA-call
overhead (driver + copy-engine launch), and 1 KiB minimum packet granularity
(matching the coloring granularity, §6.1).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

from ...obs.metrics import percentile as _pctl

KIB = 1024
PACKET = 1 * KIB


@dataclass(frozen=True)
class BusSpec:
    name: str = "pcie3x16"
    bw_h2d: float = 12.0e9          # bytes/s
    bw_d2h: float = 12.6e9
    call_overhead_s: float = 10e-6  # per DMA invocation


@dataclass
class CopyRequest:
    rid: int
    tenant: str
    priority: str                   # "LS" | "BE"
    nice: int
    size: int                       # bytes
    direction: str                  # "h2d" | "d2h"
    t_submit: float


@dataclass
class Completion:
    req: CopyRequest
    t_start: float
    t_done: float

    @property
    def latency(self) -> float:
        return self.t_done - self.req.t_submit


def bw_of(bus: BusSpec, direction: str) -> float:
    return bus.bw_h2d if direction == "h2d" else bus.bw_d2h


# ---------------------------------------------------------------------------
# workload generators (paper Tab. 3 micro-benchmark + swap scenarios)
# ---------------------------------------------------------------------------

def poisson_requests(tenant: str, priority: str, nice: int, qps: float,
                     size: int, direction: str, horizon: float,
                     seed: int = 0, start_rid: int = 0) -> List[CopyRequest]:
    rng = np.random.default_rng(seed)
    out, t, rid = [], 0.0, start_rid
    while True:
        t += rng.exponential(1.0 / qps)
        if t >= horizon:
            return out
        out.append(CopyRequest(rid, tenant, priority, nice, size, direction, t))
        rid += 1


def closed_loop_requests(tenant: str, nice: int, size: int, direction: str,
                         horizon: float, est_rate: float,
                         start_rid: int = 10_000_000) -> List[CopyRequest]:
    """BE batch copies: always another request queued (closed loop). We
    pre-materialize enough back-to-back submissions to saturate the horizon."""
    n = int(horizon * est_rate / size) + 4
    return [CopyRequest(start_rid + i, tenant, "BE", nice, size, direction, 0.0)
            for i in range(n)]


def summarize(completions: List[Completion]):
    """(LS p99 latency seconds, BE throughput bytes/s, per-tenant dict)."""
    ls_lat = [c.latency for c in completions if c.req.priority == "LS"]
    be = [c for c in completions if c.req.priority == "BE"]
    p99 = _pctl(ls_lat, 99)
    p99 = float("nan") if p99 is None else p99
    if be:
        t_end = max(c.t_done for c in be)
        thpt = sum(c.req.size for c in be) / max(t_end, 1e-9)
    else:
        thpt = 0.0
    per_tenant = {}
    for c in completions:
        per_tenant.setdefault(c.req.tenant, []).append(c.latency)
    return p99, thpt, {k: _pctl(v, 99) for k, v in per_tenant.items()}
