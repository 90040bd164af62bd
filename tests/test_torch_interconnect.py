"""The port's modeled interconnect (``repro_torch.core.interconnect``, a
copy of the reference's): the nine cases of ``tests/test_interconnect.py``
run on the port's module (per-link CFS timing, fairness, store-and-forward
routing, contention with collectives, ``link_stall`` windows, replay), and
seeded flow sets whose ``InterconnectSim.run`` completions must equal the
reference's exactly (host-star and NVLink topologies, stall windows, ring
all-gather collectives)."""
import numpy as np
import pytest

import repro.core.interconnect as jicx
import repro.serving as jserving
import repro_torch.serving as serving
from repro_torch.core.interconnect import (Flow, InterconnectSim, Topology,
                                           ring_allgather_flows)
from repro_torch.core.pcie.bus import PACKET
from repro_torch.serving import FaultEvent, FaultPlane


def _pair(bw=1e9, latency=1e-6, overhead=10e-6) -> Topology:
    t = Topology()
    t.connect("a", "b", bandwidth=bw, latency=latency,
              call_overhead_s=overhead)
    return t


# ---------------------------------------------------------------------------
# timing / Algo 6
# ---------------------------------------------------------------------------

def test_single_flow_timing_formula():
    """Uncontended flow: arrival pays the link latency, then each fetch
    quantum pays call overhead + serialized packets/bandwidth (Algo 6)."""
    bw, lat, ovh = 1e9, 1e-6, 10e-6
    topo = _pair(bw=bw, latency=lat, overhead=ovh)
    size = 4 * PACKET                 # one quantum (alloc = cfs_period)
    [c] = InterconnectSim(topo).run([Flow(0, "a", "b", size, t_submit=2.0)])
    assert c.t_start == pytest.approx(2.0 + lat)
    assert c.t_end == pytest.approx(2.0 + lat + ovh + size / bw)
    assert c.fct == pytest.approx(lat + ovh + size / bw)
    assert c.hops == 1


def test_large_flow_pays_per_quantum_overhead():
    """A flow spanning k fetch quanta pays k call overheads."""
    bw, ovh = 1e9, 10e-6
    topo = _pair(bw=bw, latency=0.0, overhead=ovh)
    period = 8
    size = 3 * period * PACKET        # 3 quanta at alloc=cfs_period=8
    [c] = InterconnectSim(topo, cfs_period=period).run(
        [Flow(0, "a", "b", size)])
    assert c.t_end == pytest.approx(3 * ovh + size / bw)


# ---------------------------------------------------------------------------
# CFS fairness / Algo 4+5
# ---------------------------------------------------------------------------

def test_nice_weighted_bandwidth_shares():
    """Two equal flows from different tenants: the nice=3 tenant drains ~3x
    faster, so it finishes first and well before the even-split point."""
    topo = _pair(bw=1e9, latency=0.0, overhead=0.0)
    size = 512 * PACKET
    comps = InterconnectSim(topo, cfs_period=8).run([
        Flow(0, "a", "b", size, tenant="slow", nice=1),
        Flow(1, "a", "b", size, tenant="fast", nice=3),
    ])
    t = {c.flow.tenant: c.t_end for c in comps}
    assert t["fast"] < t["slow"]
    # fast holds 3/4 of the link while both are active: it completes near
    # size/(0.75*bw), far sooner than the 2*size/bw even-split finish
    assert t["fast"] < 1.5 * size / 1e9
    # total service is work-conserving: last finish = total bytes / bw
    assert t["slow"] == pytest.approx(2 * size / 1e9, rel=1e-6)


def test_rejoining_tenant_inherits_min_vruntime():
    """Algo 4: a tenant joining late starts at the minimum vruntime of the
    nonempty queues instead of 0 — it cannot starve the incumbent by
    replaying its absence as credit."""
    topo = _pair(bw=1e9, latency=0.0, overhead=0.0)
    size = 256 * PACKET
    comps = InterconnectSim(topo, cfs_period=8).run([
        Flow(0, "a", "b", size, tenant="early", nice=1, t_submit=0.0),
        Flow(1, "a", "b", size, tenant="late", nice=1,
             t_submit=0.4 * size / 1e9),
    ])
    t = {c.flow.tenant: c.t_end for c in comps}
    # from the join onward the link is split evenly; early keeps its head
    # start and still finishes first
    assert t["early"] < t["late"]
    assert t["late"] == pytest.approx(2 * size / 1e9, rel=1e-6)


# ---------------------------------------------------------------------------
# routing / store-and-forward
# ---------------------------------------------------------------------------

def test_host_star_store_and_forward_two_serializations():
    """Device-to-device over the host root complex re-serializes on each
    hop; an NVLink direct link pays one serialization."""
    bw = 1e9
    star = Topology.host_star(["d0", "d1"], bandwidth=bw, latency=0.0)
    mesh = Topology.fully_connected(["d0", "d1"], bandwidth=bw, latency=0.0)
    size = 64 * PACKET
    [c2] = InterconnectSim(star).run([Flow(0, "d0", "d1", size)])
    [c1] = InterconnectSim(mesh).run([Flow(0, "d0", "d1", size)])
    assert c2.hops == 2 and c1.hops == 1
    assert c2.t_end > c1.t_end
    assert c2.t_end == pytest.approx(2 * c1.t_end, rel=1e-3)


def test_path_deterministic_and_no_route_raises():
    topo = Topology.host_star(["d0", "d1", "d2"])
    assert topo.path("d0", "d2") == [("d0", "host"), ("host", "d2")]
    assert topo.path("d0", "d0") == []
    topo.add_device("island")
    with pytest.raises(ValueError):
        topo.path("d0", "island")


# ---------------------------------------------------------------------------
# contention with collectives
# ---------------------------------------------------------------------------

def test_kv_flow_contends_with_collectives():
    """A KV page-group flow sharing its path with a ring collective
    completes later than alone, but the collective never blocks it outright
    (CFS keeps serving both tenants)."""
    devices = ["d0", "d1", "d2", "d3"]
    topo = Topology.fully_connected(devices, bandwidth=1e9, latency=0.0)
    kv = lambda: Flow(100, "d0", "d3", 128 * PACKET, tenant="kv")  # noqa: E731
    [alone] = InterconnectSim(topo).run([kv()])
    # reversed ring order so one collective hop rides the same directed
    # d0 -> d3 edge the KV flow uses (links are directed per direction)
    bg = ring_allgather_flows(topo, devices[::-1], 256 * PACKET, rounds=2)
    comps = InterconnectSim(topo).run(bg + [kv()])
    contended = next(c for c in comps if c.flow.tenant == "kv")
    assert contended.t_end > alone.t_end
    assert len(comps) == len(bg) + 1          # everything still completes


def test_link_stall_delays_never_drops():
    """A link_stall window idles the schedule to the window edge; all flows
    still complete afterwards (delay, never loss)."""
    topo = _pair(bw=1e9, latency=0.0, overhead=0.0)
    size = 16 * PACKET
    flows = [Flow(i, "a", "b", size) for i in range(3)]
    base = InterconnectSim(topo).run([Flow(i, "a", "b", size)
                                      for i in range(3)])
    plane = FaultPlane([FaultEvent(0.0, "link_stall", duration=1e-3)])
    stalled = InterconnectSim(topo).run(flows, faults=plane)
    assert len(stalled) == 3
    assert all(c.t_end >= 1e-3 for c in stalled)
    assert max(c.t_end for c in stalled) == pytest.approx(
        1e-3 + max(c.t_end for c in base), rel=1e-6)


# ---------------------------------------------------------------------------
# determinism oracle
# ---------------------------------------------------------------------------

def test_multi_device_replay_bit_identical():
    """Seeded multi-device flow schedule replays bit-identically: same
    flows, same topology -> identical (fid, t_start, t_end, hops) tuples,
    in identical order."""
    rng = np.random.default_rng(42)
    devices = [f"d{i}" for i in range(4)]
    topo = Topology.host_star(devices, bandwidth=8e9, latency=2e-6)

    def flows():
        out = []
        for i in range(40):
            src, dst = rng.choice(4, size=2, replace=False)
            out.append(Flow(i, f"d{src}", f"d{dst}",
                            int(rng.integers(1, 64)) * PACKET,
                            tenant=f"t{i % 3}", nice=1 + i % 2,
                            t_submit=float(rng.uniform(0, 1e-3))))
        return out

    fl = flows()
    a = InterconnectSim(topo).run(list(fl))
    b = InterconnectSim(topo).run(list(fl))
    sig = lambda cs: [(c.flow.fid, c.t_start, c.t_end, c.hops)  # noqa: E731
                      for c in cs]
    assert sig(a) == sig(b)
    assert len(a) == 40


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------

def _scenario(icx, sv, topo_kind: str, seed: int):
    """One seeded flow set on either side: KV page-group flows between
    random device pairs, two rounds of a ring all-gather, and (seed odd)
    two ``link_stall`` windows over the run."""
    rng = np.random.default_rng(seed)
    devices = [f"dev{i}" for i in range(4)]
    if topo_kind == "host_star":
        topo = icx.Topology.host_star(devices, bandwidth=12e9, latency=5e-6)
    else:
        topo = icx.Topology.fully_connected(devices, bandwidth=300e9,
                                            latency=1e-6)
    flows = icx.ring_allgather_flows(topo, devices, 64 * PACKET, rounds=2,
                                     t=float(rng.uniform(0, 1e-4)))
    fid = len(flows)
    for i in range(24):
        src, dst = rng.choice(4, size=2, replace=False)
        flows.append(icx.Flow(fid + i, devices[src], devices[dst],
                              int(rng.integers(1, 96)) * PACKET,
                              tenant=f"kv:t{i % 3}", nice=1 + i % 3,
                              priority="LS" if i % 4 == 0 else "BE",
                              t_submit=float(rng.uniform(0, 5e-4))))
    faults = None
    if seed % 2:
        faults = sv.FaultPlane([
            sv.FaultEvent(float(rng.uniform(0, 2e-4)), "link_stall",
                          duration=float(rng.uniform(1e-5, 1e-4))),
            sv.FaultEvent(float(rng.uniform(2e-4, 6e-4)), "link_stall",
                          duration=float(rng.uniform(1e-5, 1e-4)))])
    comps = icx.InterconnectSim(topo).run(flows, faults=faults)
    return [(c.flow.fid, c.flow.src, c.flow.dst, c.flow.size, c.flow.tenant,
             c.flow.kind, c.t_start, c.t_end, c.hops, c.to_event())
            for c in comps]


@pytest.mark.parametrize("topo_kind", ["host_star", "nvlink"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_completions_equal_reference(topo_kind, seed):
    import repro_torch.core.interconnect as icx
    ref = _scenario(jicx, jserving, topo_kind, seed)
    port = _scenario(icx, serving, topo_kind, seed)
    assert len(port) == len(ref) > 24
    assert port == ref
