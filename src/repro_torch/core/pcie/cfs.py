"""PCIe Completely Fair Scheduler — the paper's Algo 4 (AddTasks), Algo 5
(FetchTasks) and Algo 6 (CfsSchedule), simulated event-driven per direction.

Each tenant has a queue with a `nice` weight and a `vruntime`. A joining
tenant inherits the global minimum vruntime (Algo 4). Each scheduling
decision picks the min-vruntime queue, grants it AllocTime =
cfs_period / n_queues packets, and charges vruntime by
AllocTime * sum_nice / nice (Algo 5) — so bandwidth shares converge to
nice_i / sum(nice). Requests are decomposed into 1 KiB packets (§6.1); LS
responsiveness is bounded by one fetch quantum.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from .bus import (PACKET, BusSpec, Completion, CopyRequest, bw_of)


@dataclass
class _Queue:
    tenant: str
    nice: int
    vruntime: float = 0.0
    pending: List = field(default_factory=list)   # [(req, remaining_packets)]

    def push(self, req):
        self.pending.append([req, -(-req.size // PACKET)])


class PCIeCFS:
    """cfs_period is in packets (paper §6.3: 2048 packets = 2 MiB/period on
    PCIe 3.0 x16)."""

    def __init__(self, cfs_period: int = 2048):
        self.cfs_period = cfs_period

    def run(self, requests: List[CopyRequest], bus: BusSpec,
            direction: str | None = None, faults=None) -> List[Completion]:
        """``faults`` (serving.faults.FaultPlane): inside a ``link_stall``
        window no fetch quantum starts — the scheduler idles to the window
        edge and resumes. Transfers are delayed, never dropped, and the
        vruntime fairness accounting is untouched by the stall."""
        if direction is None:
            out = []
            for d in ("h2d", "d2h"):
                out += self.run([r for r in requests if r.direction == d],
                                bus, d, faults=faults)
            return out
        reqs = sorted(requests, key=lambda r: r.t_submit)
        bw = bw_of(bus, direction)
        queues: Dict[str, _Queue] = {}
        t = 0.0
        i = 0
        done: List[Completion] = []
        started: Dict[int, float] = {}

        def admit(until):
            nonlocal i
            while i < len(reqs) and reqs[i].t_submit <= until:
                r = reqs[i]
                q = queues.get(r.tenant)
                fresh = q is None or not q.pending
                if q is None:
                    q = _Queue(r.tenant, r.nice)
                    queues[r.tenant] = q
                if fresh:                            # Algo 4: a (re)joining
                    nonempty = [x for x in queues.values()
                                if x.pending and x is not q]
                    q.vruntime = (min(x.vruntime for x in nonempty)
                                  if nonempty else 0.0)
                q.push(r)
                i += 1

        admit(t)
        while i < len(reqs) or any(q.pending for q in queues.values()):
            active = [q for q in queues.values() if q.pending]
            if not active:
                t = max(t, reqs[i].t_submit)
                admit(t)
                continue
            if faults is not None:
                stall_end = faults.stall_until(t)
                if stall_end > t:        # link down: idle to the window edge
                    t = stall_end
                    admit(t)
                    continue
            # ---- Algo 5: FetchTasks ----
            sum_nice = sum(q.nice for q in active)
            sel = min(active, key=lambda q: q.vruntime)
            alloc = max(1, self.cfs_period // len(active))
            # take up to `alloc` packets from the front of sel's queue
            got = 0
            finished_now = []
            for entry in sel.pending:
                take = min(entry[1], alloc - got)
                if take > 0:
                    started.setdefault(entry[0].rid, t)
                entry[1] -= take
                got += take
                if entry[1] == 0:
                    finished_now.append(entry[0])
                if got >= alloc:
                    break
            sel.pending = [e for e in sel.pending if e[1] > 0]
            sel.vruntime += alloc * (sum_nice / sel.nice)
            # ---- Algo 6: one cuMemcpy for the fetched packet run ----
            dt = bus.call_overhead_s + got * PACKET / bw
            t += dt
            for r in finished_now:
                done.append(Completion(r, started[r.rid], t))
            admit(t)
        return done
