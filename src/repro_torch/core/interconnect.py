"""Modeled device interconnect: links, topology and contended flows.

The disaggregated serving path (serving.disagg) ships finished KV page
groups from prefill devices to decode devices. This module is the modeled
wire those transfers ride: a device graph with PCIe/NVLink-class edges
(:class:`Topology`), point-to-point :class:`Flow` s, and a discrete-event
:class:`InterconnectSim` that serves every link with the *same* completely
fair scheduling discipline as the host PCIe bus (``core.pcie.cfs`` — the
paper's Algo 4/5/6: per-tenant queues with ``nice`` weights, min-vruntime
fetch, ``cfs_period``-packet quanta), so KV-page flows contend with
collectives and with each other exactly like host swap traffic contends on
the PCIe bus, and bandwidth shares converge to ``nice_i / sum(nice)``.

Multi-hop flows are store-and-forward: a flow's packets serialize fully on
hop ``k`` before the next hop sees them, and each hop charges its link's
propagation latency on entry — the PCIe host-bridge topology
(:meth:`Topology.host_star`) therefore pays two serializations per
device-to-device page group, while an NVLink-class mesh
(:meth:`Topology.fully_connected`) pays one.

Everything is deterministic: quanta are processed in global start-time
order with index tie-breaks and no randomness, so a seeded multi-device
run replays bit-identically (the determinism oracle in
tests/test_interconnect.py). An attached fault plane's ``link_stall``
windows idle every link to the window edge — transfers are delayed, never
dropped, and the vruntime accounting is untouched (same contract as
``PCIeCFS.run``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .pcie.bus import PACKET


@dataclass(frozen=True)
class Link:
    """One directed edge of the device graph. ``bandwidth`` in bytes/s,
    ``latency`` in seconds (propagation, charged once per hop on entry),
    ``call_overhead_s`` per fetch quantum (the cuMemcpy-call analogue the
    PCIe model charges)."""
    bandwidth: float
    latency: float = 0.0
    kind: str = "pcie"            # pcie | nvlink | ...
    call_overhead_s: float = 10e-6


class Topology:
    """Device graph with class-tagged edges and deterministic routing.

    ``connect`` inserts directed links (both directions unless
    ``bidir=False``); ``path`` routes with BFS over insertion-ordered
    neighbor lists, so the route — and with it every modeled transfer
    time — is a pure function of construction order."""

    def __init__(self):
        self.devices: List[str] = []
        self.links: Dict[Tuple[str, str], Link] = {}

    def add_device(self, name: str):
        if name not in self.devices:
            self.devices.append(name)
        return self

    def connect(self, a: str, b: str, *, bandwidth: float,
                latency: float = 0.0, kind: str = "pcie",
                call_overhead_s: float = 10e-6, bidir: bool = True):
        self.add_device(a)
        self.add_device(b)
        link = Link(bandwidth, latency, kind, call_overhead_s)
        self.links[(a, b)] = link
        if bidir:
            self.links[(b, a)] = link
        return self

    def neighbors(self, a: str) -> List[str]:
        return [d for (s, d) in self.links if s == a]

    def path(self, src: str, dst: str) -> List[Tuple[str, str]]:
        """Hop list [(a, b), ...] from src to dst (deterministic BFS)."""
        if src == dst:
            return []
        prev: Dict[str, str] = {src: src}
        frontier = [src]
        while frontier and dst not in prev:
            nxt: List[str] = []
            for node in frontier:
                for nb in self.neighbors(node):
                    if nb not in prev:
                        prev[nb] = node
                        nxt.append(nb)
            frontier = nxt
        if dst not in prev:
            raise ValueError(f"no route {src!r} -> {dst!r}")
        hops: List[Tuple[str, str]] = []
        node = dst
        while node != src:
            hops.append((prev[node], node))
            node = prev[node]
        return hops[::-1]

    # -- canonical shapes ----------------------------------------------
    @classmethod
    def host_star(cls, devices, *, bandwidth: float = 12e9,
                  latency: float = 5e-6, kind: str = "pcie",
                  host: str = "host") -> "Topology":
        """PCIe through the host root complex: every device hangs off one
        ``host`` node, so device-to-device page groups store-and-forward
        through it (two serializations, the d2h+h2d reality of
        cudaMemcpyPeer without P2P)."""
        topo = cls()
        topo.add_device(host)
        for d in devices:
            topo.connect(host, d, bandwidth=bandwidth, latency=latency,
                         kind=kind)
        return topo

    @classmethod
    def fully_connected(cls, devices, *, bandwidth: float = 300e9,
                        latency: float = 1e-6,
                        kind: str = "nvlink") -> "Topology":
        """NVLink-class all-to-all: one direct hop between any pair."""
        topo = cls()
        devices = list(devices)
        for i, a in enumerate(devices):
            for b in devices[i + 1:]:
                topo.connect(a, b, bandwidth=bandwidth, latency=latency,
                             kind=kind)
        return topo


@dataclass
class Flow:
    """One point-to-point transfer (a KV page group, a collective shard).
    ``tenant``/``nice`` feed the per-link CFS exactly like a
    ``CopyRequest`` feeds the host PCIe scheduler."""
    fid: int
    src: str
    dst: str
    size: int                     # bytes
    tenant: str = "kv"
    priority: str = "BE"          # LS | BE (reporting only; nice arbitrates)
    nice: int = 1
    t_submit: float = 0.0
    kind: str = "kv"              # kv | collective | ...


@dataclass
class FlowCompletion:
    flow: Flow
    t_start: float                # first packet served on the first hop
    t_end: float                  # last packet lands at the destination
    hops: int

    @property
    def fct(self) -> float:
        """Flow completion time (submit -> last byte at destination)."""
        return self.t_end - self.flow.t_submit

    def to_event(self) -> dict:
        """Canonical ``kind="flow"`` telemetry event (see repro.obs.schema):
        one instant per completed flow on the wire track, carrying the full
        lifetime so exporters can render it as a complete slice."""
        f = self.flow
        return {"t": float(self.t_start), "ph": "I", "kind": "flow",
                "name": f"f{f.fid}", "track": f"wire/{f.src}->{f.dst}",
                "args": {"src": f.src, "dst": f.dst, "bytes": int(f.size),
                         "tenant": f.tenant, "priority": f.priority,
                         "kind": f.kind, "t_submit": float(f.t_submit),
                         "t_start": float(self.t_start),
                         "t_end": float(self.t_end), "hops": int(self.hops),
                         "fct": float(self.fct)}}


@dataclass
class _Job:
    """One flow's residency on one hop."""
    flow: Flow
    path: List[Tuple[str, str]]
    hop: int
    remaining: int                # packets left on this hop
    t_start: Optional[float] = None   # first-hop service start


@dataclass
class _TenantQ:
    tenant: str
    nice: int
    vruntime: float = 0.0
    pending: List[_Job] = field(default_factory=list)


class _LinkState:
    def __init__(self, link: Link):
        self.link = link
        self.t = 0.0
        self.queues: Dict[str, _TenantQ] = {}
        self.arrivals: List[Tuple[float, int, _Job]] = []   # kept sorted

    def has_pending(self) -> bool:
        return any(q.pending for q in self.queues.values())

    def next_start(self) -> float:
        """Earliest time this link can begin its next fetch quantum."""
        if self.has_pending():
            return self.t
        if self.arrivals:
            return max(self.t, self.arrivals[0][0])
        return float("inf")

    def admit(self, until: float):
        """Algo 4 (AddTasks): a (re)joining tenant inherits the global
        minimum vruntime among the link's nonempty queues."""
        while self.arrivals and self.arrivals[0][0] <= until + 1e-15:
            _, _, job = self.arrivals.pop(0)
            name = job.flow.tenant
            q = self.queues.get(name)
            fresh = q is None or not q.pending
            if q is None:
                q = _TenantQ(name, max(int(job.flow.nice), 1))
                self.queues[name] = q
            if fresh:
                nonempty = [x for x in self.queues.values()
                            if x.pending and x is not q]
                q.vruntime = (min(x.vruntime for x in nonempty)
                              if nonempty else 0.0)
            q.pending.append(job)


class InterconnectSim:
    """Discrete-event network simulation over a :class:`Topology`.

    Every link runs the PCIe CFS discipline independently (per-tenant
    queues, min-vruntime fetch of ``cfs_period // n_active`` packets,
    vruntime charged by ``alloc * sum_nice / nice``); the global loop
    executes fetch quanta in start-time order with link-index tie-breaks.
    ``faults`` (serving.faults.FaultPlane): inside a ``link_stall`` window
    no quantum starts on any link — the schedule idles to the window edge
    (delay, never loss)."""

    def __init__(self, topology: Topology, cfs_period: int = 2048):
        self.topology = topology
        self.cfs_period = cfs_period

    def run(self, flows: List[Flow], faults=None) -> List[FlowCompletion]:
        links = list(self.topology.links)
        states = {e: _LinkState(self.topology.links[e]) for e in links}
        order = {e: i for i, e in enumerate(links)}
        seq = 0
        for fl in sorted(flows, key=lambda f: (f.t_submit, f.fid)):
            path = self.topology.path(fl.src, fl.dst)
            if not path:
                continue
            job = _Job(fl, path, 0, -(-int(fl.size) // PACKET))
            st = states[path[0]]
            st.arrivals.append(
                (fl.t_submit + st.link.latency, seq, job))
            seq += 1
        for st in states.values():
            st.arrivals.sort(key=lambda e: (e[0], e[1]))

        done: List[FlowCompletion] = []
        while True:
            edge = min(links,
                       key=lambda e: (states[e].next_start(), order[e]))
            st = states[edge]
            start = st.next_start()
            if start == float("inf"):
                break
            st.t = start
            st.admit(st.t)
            if faults is not None:
                stall_end = faults.stall_until(st.t)
                if stall_end > st.t:      # link down: idle to the edge
                    st.t = stall_end
                    continue
            active = [q for q in st.queues.values() if q.pending]
            if not active:
                continue
            # ---- Algo 5: min-vruntime fetch of one packet quantum ----
            sum_nice = sum(q.nice for q in active)
            sel = min(active, key=lambda q: q.vruntime)
            alloc = max(1, self.cfs_period // len(active))
            got = 0
            finished: List[_Job] = []
            for job in sel.pending:
                take = min(job.remaining, alloc - got)
                if take > 0 and job.hop == 0 and job.t_start is None:
                    job.t_start = st.t
                job.remaining -= take
                got += take
                if job.remaining == 0:
                    finished.append(job)
                if got >= alloc:
                    break
            sel.pending = [j for j in sel.pending if j.remaining > 0]
            sel.vruntime += alloc * (sum_nice / sel.nice)
            # ---- Algo 6: one serialized fetch for the packet run ----
            st.t += st.link.call_overhead_s + got * PACKET / st.link.bandwidth
            for job in finished:
                if job.hop + 1 < len(job.path):
                    job.hop += 1
                    job.remaining = -(-int(job.flow.size) // PACKET)
                    nxt = states[job.path[job.hop]]
                    t_arr = st.t + nxt.link.latency
                    nxt.arrivals.append((t_arr, seq, job))
                    seq += 1
                    nxt.arrivals.sort(key=lambda e: (e[0], e[1]))
                else:
                    done.append(FlowCompletion(job.flow, job.t_start,
                                               st.t, len(job.path)))
        return sorted(done, key=lambda c: (c.t_end, c.flow.fid))


def ring_allgather_flows(topology: Topology, devices, size: int, *,
                         tenant: str = "collective", nice: int = 1,
                         t: float = 0.0, rounds: int = 1,
                         fid0: int = 0) -> List[Flow]:
    """Ring collective as flows: each round ships ``size`` bytes from every
    device to its ring successor — the background traffic KV-page flows
    must contend with on shared links (the AI-factory network-sim idiom)."""
    devices = list(devices)
    out: List[Flow] = []
    fid = fid0
    for r in range(rounds):
        for i, src in enumerate(devices):
            dst = devices[(i + 1) % len(devices)]
            if src == dst:
                continue
            out.append(Flow(fid, src, dst, int(size), tenant=tenant,
                            nice=nice, t_submit=t + r * 1e-6,
                            kind="collective"))
            fid += 1
    return out
