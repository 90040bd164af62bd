"""Baseline PCIe schedulers the paper compares against (§3.3, §8.1.2):

  * MultiStream — unmanaged parallel DMA (Orion / plain multi-streaming):
    all in-flight transfers share bandwidth equally (processor sharing).
  * Baymax — priority reordering of the submission queue, but NON-preemptive:
    an in-flight BE bulk transfer blocks a newly arrived LS request
    (the source of Baymax's orders-of-magnitude LS p99 in Tab. 3).
  * StreamBox — packetized strict-priority preemption: LS preempts BE at
    packet granularity; no weighted sharing between tenants of one class.
"""
from __future__ import annotations

from typing import List

from .bus import PACKET, BusSpec, Completion, CopyRequest, bw_of


def _by_dir(requests, direction):
    return sorted([r for r in requests if r.direction == direction],
                  key=lambda r: r.t_submit)


class MultiStream:
    """Processor-sharing among active transfers; one stream per tenant, and
    transfers on a stream serialize (CUDA stream semantics)."""

    def run(self, requests: List[CopyRequest], bus: BusSpec,
            direction: str | None = None) -> List[Completion]:
        if direction is None:
            return (self.run(requests, bus, "h2d")
                    + self.run(requests, bus, "d2h"))
        reqs = _by_dir(requests, direction)
        bw = bw_of(bus, direction)
        t = 0.0
        i = 0
        waiting: dict = {}               # tenant -> FIFO of queued requests
        active = []                      # [req, remaining_bytes, t_start]
        busy = set()                     # tenants with an in-flight transfer
        done: List[Completion] = []

        def promote(now):
            for tn, fifo in waiting.items():
                if fifo and tn not in busy:
                    r = fifo.pop(0)
                    active.append([r, float(r.size), now])
                    busy.add(tn)

        while i < len(reqs) or active or any(waiting.values()):
            if not active and not any(waiting.values()):
                t = max(t, reqs[i].t_submit)
            while i < len(reqs) and reqs[i].t_submit <= t:
                waiting.setdefault(reqs[i].tenant, []).append(reqs[i])
                i += 1
            promote(t)
            share = bw / len(active)
            t_fin = t + min(a[1] for a in active) / share
            t_next = reqs[i].t_submit if i < len(reqs) else float("inf")
            t_new = min(t_fin, t_next)
            for a in active:
                a[1] -= (t_new - t) * share
            t = t_new
            still = []
            for a in active:
                if a[1] <= 0.5:        # sub-byte residual => finished
                    done.append(Completion(a[0], a[2], t))
                    busy.discard(a[0].tenant)
                else:
                    still.append(a)
            active = still
        return done


class Baymax:
    """LS-first reordering, non-preemptive service."""

    def run(self, requests: List[CopyRequest], bus: BusSpec,
            direction: str | None = None) -> List[Completion]:
        if direction is None:
            return (self.run(requests, bus, "h2d")
                    + self.run(requests, bus, "d2h"))
        reqs = _by_dir(requests, direction)
        bw = bw_of(bus, direction)
        t = 0.0
        i = 0
        queue: List[CopyRequest] = []
        done: List[Completion] = []
        while i < len(reqs) or queue:
            if not queue:
                t = max(t, reqs[i].t_submit)
            while i < len(reqs) and reqs[i].t_submit <= t:
                queue.append(reqs[i])
                i += 1
            queue.sort(key=lambda r: (r.priority != "LS", r.t_submit))
            r = queue.pop(0)
            t0 = t
            t += bus.call_overhead_s + r.size / bw     # runs to completion
            done.append(Completion(r, t0, t))
        return done


class StreamBox:
    """Strict-priority preemption at packet granularity."""

    def __init__(self, quantum_packets: int = 2048):
        self.quantum = quantum_packets

    def run(self, requests: List[CopyRequest], bus: BusSpec,
            direction: str | None = None) -> List[Completion]:
        if direction is None:
            return (self.run(requests, bus, "h2d")
                    + self.run(requests, bus, "d2h"))
        reqs = _by_dir(requests, direction)
        bw = bw_of(bus, direction)
        t = 0.0
        i = 0
        ls: List[list] = []
        be: List[list] = []
        started = {}
        done: List[Completion] = []
        while i < len(reqs) or ls or be:
            if not (ls or be):
                t = max(t, reqs[i].t_submit)
            while i < len(reqs) and reqs[i].t_submit <= t:
                (ls if reqs[i].priority == "LS" else be).append(
                    [reqs[i], -(-reqs[i].size // PACKET)])
                i += 1
            cur = ls[0] if ls else be[0]
            take = min(cur[1], self.quantum)
            started.setdefault(cur[0].rid, t)
            t += bus.call_overhead_s + take * PACKET / bw
            cur[1] -= take
            if cur[1] == 0:
                done.append(Completion(cur[0], started[cur[0].rid], t))
                (ls if cur[0].priority == "LS" else be).pop(0)
        return done
