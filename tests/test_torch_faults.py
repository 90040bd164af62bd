"""The port's fault plane and recovery ladder against the reference: twins
of ``tests/test_faults.py`` (all but the simulator's ``bw_degrade`` test,
which needs the port's simulator backend).

``serving/faults.py`` and ``core/pcie`` are copies of the reference's, so
the plane's windows, points, storms and observation log, ``safe_floor``
and the CFS under a link stall are checked against the reference's on the
same inputs. The host tier's checksummed pages are checked on the port's
torch pools. Every engine recovery path runs the port's engine and the
reference engine on one virtual clock with the same weights
(``_torch_serving_parity``): tokens, failed/shed/rejected, quantum order,
the quantum log, the ``faults`` rollup, the plane's observation log and the
host pools must agree, beside the reference test's own checks on the
port. The fault-interleaving oracle holds every surviving request
bit-equal to the fault-free run, with its not-vacuous guard. Last, one
traced seeded LS + BE run with the prefix cache, growth, the fp16 swap
tier and a fault storm: its JSONL is byte-equal to the reference's and
passes the reference's schema checker, with the ``swap``, ``fault`` and
``recovery`` kinds in it.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _hypothesis_compat import given, settings, st  # noqa: E402
import _torch_serving_parity as par  # noqa: E402

import repro.core.pcie as jpcie  # noqa: E402
import repro.serving as jserving  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro.obs import schema as jschema  # noqa: E402
import repro_torch.serving as serving  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import pcie  # noqa: E402
from repro_torch.core.controller import ResourcePlan  # noqa: E402
from repro_torch.serving import (ColdPageCorrupt, FaultEvent,  # noqa: E402
                                 FaultPlane, HostSwapPool, HostTierFault,
                                 Phase, safe_floor)

MAX_SEQ = 32
PAGE = 4


@pytest.fixture(scope="module")
def tiny():
    return par.tiny_models()


# ---------------------------------------------------------------------------
# FaultPlane unit behaviour, against the reference's
# ---------------------------------------------------------------------------

def _windows(mod):
    evs = [mod.FaultEvent(1.0, "link_stall", duration=2.0),
           mod.FaultEvent(5.0, "page_corrupt"),
           mod.FaultEvent(2.0, "swap_write_fail", duration=1.0,
                          target="be0")]
    p = mod.FaultPlane(evs)
    seen = [p.active("link_stall", t) is not None
            for t in (0.5, 1.0, 2.9, 3.0)]
    seen += [p.active("swap_write_fail", 2.5, target=t) is not None
             for t in ("ls0", "be0")]
    seen += [p.fires("page_corrupt", t) for t in (4.9, 5.1, 6.0)]
    q = mod.FaultPlane(evs)
    q.active("link_stall", 1.0)
    q.active("swap_write_fail", 2.5, target="be0")
    q.fires("page_corrupt", 5.1)
    return seen, p.counts(), p.log, [e["kind"] for e in q.log]


def test_fault_plane_windows_points_and_determinism():
    seen, counts, log, qlog = _windows(jserving)
    assert _windows(serving) == (seen, counts, log, qlog)
    # end-exclusive windows, target scoping, one-shot points
    assert seen == [False, True, True, False, False, True,
                    False, True, False]
    assert counts == {"link_stall": 1, "swap_write_fail": 1,
                      "page_corrupt": 1}
    # identical query sequence -> identical observation log
    assert qlog == [e["kind"] for e in log if e["kind"] in counts]


def _storm(mod):
    return mod.FaultPlane.storm(horizon=50.0, seed=11,
                                rates={"bw_degrade": 0.2,
                                       "page_corrupt": 0.1},
                                duration=2.0, magnitude=0.5)


def test_fault_storm_seeded_and_boundary():
    a, b = _storm(serving), _storm(jserving)
    key = lambda p: [(e.t, e.kind, e.duration, e.magnitude, e.target)
                     for e in p.events]
    assert key(a) == key(b) == key(_storm(serving))
    assert any(e.kind == "bw_degrade" for e in a.events)
    # corrupt events are points regardless of the storm's window duration
    assert all(e.duration == 0.0 for e in a.events
               if e.kind == "page_corrupt")
    # next_boundary never lands inside a window span
    w = next(e for e in a.events if e.duration > 0)
    assert a.next_boundary(w.t - 1e-6) <= w.t
    assert a.next_boundary(w.t) == pytest.approx(w.end)
    assert [a.next_boundary(t) for t in np.linspace(0, 50, 101)] == [
        b.next_boundary(t) for t in np.linspace(0, 50, 101)]


def test_safe_floor_clamps_down_only():
    import repro.core.controller as jctl
    for plan in ((1.0, 1.0, 0.5, (), (), 2.0),
                 (0.05, 0.1, 0.5, (), (), 2.0)):
        kw = {} if plan[0] == 1.0 else {"prefill_budget": 4}
        f, g = (safe_floor(ResourcePlan(*plan, **kw)),
                jserving.safe_floor(jctl.ResourcePlan(*plan, **kw)))
        assert (f.sm_be, f.ch_be, f.prefill_budget) == (
            g.sm_be, g.ch_be, g.prefill_budget)
    f = safe_floor(ResourcePlan(1.0, 1.0, 0.5, (), (), 2.0))
    assert f.sm_be == pytest.approx(0.1)
    assert f.ch_be == pytest.approx(1 / 6)
    assert f.prefill_budget == 8
    g = safe_floor(ResourcePlan(0.05, 0.1, 0.5, (), (), 2.0,
                                prefill_budget=4))
    assert g.sm_be == 0.05 and g.ch_be == 0.1 and g.prefill_budget == 4


# ---------------------------------------------------------------------------
# host tier: checksummed cold pages on the port's pools
# ---------------------------------------------------------------------------

def _pools():
    arr = np.random.default_rng(0).normal(size=(1, 4, 2, 4, 8))
    return {"layers": {"k": torch.from_numpy(arr.astype(np.float32))}}


def test_cold_page_corruption_caught_by_checksum():
    plane = FaultPlane([FaultEvent(0.0, "page_corrupt")])
    host = HostSwapPool("fp16", faults=plane, verify=True)
    host.put(_pools(), "pg", 2, t=1.0)
    with pytest.raises(ColdPageCorrupt):
        host.get(_pools(), "pg", 2, t=2.0)
    assert "pg" not in host                 # corrupt copy discarded
    assert host.corruptions == 1


def test_cold_page_corruption_served_silently_without_verify():
    """The naive ablation: verify=False writes the rotted page back —
    exactly the silent divergence the checksum exists to prevent."""
    plane = FaultPlane([FaultEvent(0.0, "page_corrupt")])
    host = HostSwapPool("fp16", faults=plane, verify=False)
    pools = _pools()
    before = pools["layers"]["k"][:, 2].clone()
    host.put(pools, "pg", 2, t=1.0)
    pools, _ = host.get(pools, "pg", 2, t=2.0)
    assert host.corruptions == 0
    assert not torch.equal(pools["layers"]["k"][:, 2], before)


def test_swap_write_fault_raises_before_mutation():
    plane = FaultPlane([FaultEvent(0.0, "swap_write_fail", duration=10.0)])
    host = HostSwapPool("fp16", faults=plane)
    with pytest.raises(HostTierFault):
        host.put(_pools(), "pg", 1, t=5.0)
    assert "pg" not in host and host.write_faults == 1
    host.put(_pools(), "pg", 1, t=20.0)     # window over: writes succeed
    assert "pg" in host


def test_swap_read_fault_keeps_page_resident():
    plane = FaultPlane([FaultEvent(5.0, "swap_read_fail", duration=10.0)])
    host = HostSwapPool("fp16", faults=plane)
    host.put(_pools(), "pg", 1, t=0.0)
    with pytest.raises(HostTierFault):
        host.get(_pools(), "pg", 1, t=6.0)
    assert "pg" in host                     # retryable: page survives
    host.get(_pools(), "pg", 1, t=20.0)
    assert "pg" not in host and host.read_faults == 1


# ---------------------------------------------------------------------------
# PCIe CFS: link stalls delay, never drop
# ---------------------------------------------------------------------------

def _stalled(pc, sv):
    bus = pc.BusSpec()
    reqs = [pc.CopyRequest(i, "ls0", "LS", 10, 64 * 1024, "h2d", 0.001 * i)
            for i in range(4)]
    clean = pc.PCIeCFS().run(reqs, bus)
    plane = sv.FaultPlane([sv.FaultEvent(0.0, "link_stall", duration=0.05)])
    stalled = pc.PCIeCFS().run(reqs, bus, faults=plane)
    return reqs, clean, stalled, plane.counts()


def test_cfs_link_stall_delays_but_completes():
    reqs, clean, stalled, counts = _stalled(pcie, serving)
    _, jclean, jstalled, _ = _stalled(jpcie, jserving)
    key = lambda cs: [(c.req.rid, c.t_start, c.t_done) for c in cs]
    assert key(clean) == key(jclean) and key(stalled) == key(jstalled)
    assert len(stalled) == len(clean) == 4
    assert {c.req.rid for c in stalled} == {r.rid for r in reqs}
    # nothing starts inside the stall window; everything lands after it
    assert min(c.t_start for c in stalled) >= 0.05
    assert max(c.t_done for c in stalled) > max(c.t_done for c in clean)
    assert counts.get("link_stall") == 1


# ---------------------------------------------------------------------------
# engine recovery paths, port against reference
# ---------------------------------------------------------------------------

def _engine(s, clock, *, tenants=("be0",), kv_pages=None, slots=3, **kw):
    kw.setdefault("grow_pages", True)
    kw.setdefault("swap", True)
    kw.setdefault("cold_dtype", "fp16")
    return par.build(s, clock, tenants=tenants, max_seq=MAX_SEQ, paged=True,
                     page_size=PAGE, kv_pages=kv_pages, slots_ls=slots,
                     slots_be=slots, chunk_size=PAGE, **kw)


def _plane(s, events):
    return s.sv.FaultPlane([s.sv.FaultEvent(*a, **k) for a, k in events])


def _serve(s, clock, *, prompts, max_new=10, kv_pages=6, deadline=None,
           faults=None, **kw):
    eng = _engine(s, clock, kv_pages=kv_pages,
                  faults=None if faults is None else faults(s), **kw)
    reqs = [eng.submit("be0", p, max_new=max_new, deadline=deadline)
            for p in prompts]
    par.drive(eng, clock)
    return eng, reqs


def _clean(tiny, prompts, **kw):
    _, reqs = _serve(par.side(tiny, "port"), {"t": 0.0}, prompts=prompts,
                     **kw)
    return [list(r.output) for r in reqs]


def test_swap_write_fault_falls_back_to_preempt(tiny):
    """A permanent write-fault window turns every swap-out into a
    preempt-restart; with fault_budget=1 the ladder also records the
    swap_to_preempt rung. Tokens stay bit-equal to the clean run."""
    prompts = par.prompts(5, 4)
    clean = _clean(tiny, prompts)
    assert all(len(t) == 10 for t in clean)
    plane = lambda s: _plane(s, [((0.0, "swap_write_fail"),
                                  {"duration": 1e9})])
    ref, port, eng = par.run_both(tiny, _serve, prompts=prompts,
                                  faults=plane, fault_budget=1)
    par.assert_same(ref, port)
    rt = eng.tenants["be0"]
    assert rt.swap_outs == 0 and rt.preemptions > 0
    assert rt.fault_recoveries.get("swap_write", 0) > 0
    assert "swap_to_preempt" in rt.degraded
    assert port["faults"]["degraded"] and port["faults"]["recovered"]
    assert port["tokens"] == clean


def test_swap_read_fault_retries_then_recovers(tiny):
    """A transient read-fault window is ridden out by retry with backoff;
    the request resumes from its host pages and tokens stay bit-equal."""
    prompts = par.prompts(9, 4)
    clean = _clean(tiny, prompts)
    # patience outlasts the window: ride it out on retries alone, without
    # the grow-deadlock shed kicking in first
    plane = lambda s: _plane(s, [((0.0, "swap_read_fail"),
                                  {"duration": 40.0})])
    ref, port, eng = par.run_both(tiny, _serve, prompts=prompts,
                                  faults=plane, swap_retry_limit=100,
                                  deadlock_patience=500)
    par.assert_same(ref, port)
    rt = eng.tenants["be0"]
    assert not any(f[0] for f in port["flags"])
    assert port["tokens"] == clean
    assert rt.shed == 0
    assert rt.swap_retries > 0          # the window was actually ridden out
    assert rt.swap_ins > 0              # and the host pages did come back


def test_corrupt_cold_page_restarts_with_equal_tokens(tiny):
    """Every host page the storm can reach is corrupted; the CRC check
    turns each into a preempt-restart and the streams stay bit-equal."""
    prompts = par.prompts(13, 4)
    clean = _clean(tiny, prompts)
    plane = lambda s: _plane(s, [((0.0, "page_corrupt"), {})] * 64)
    ref, port, eng = par.run_both(tiny, _serve, prompts=prompts,
                                  faults=plane)
    par.assert_same(ref, port)
    rt = eng.tenants["be0"]
    assert port["tokens"] == clean
    assert rt.host.corruptions > 0
    assert rt.fault_recoveries.get("swap_read", 0) > 0


def _alloc_window(s, clock):
    plane = _plane(s, [((3.0, "alloc_fail"), {"duration": 20.0})])
    eng = _engine(s, clock, swap=False, grow_pages=False, prefix_cache=True,
                  faults=plane)
    rt = eng.tenants["be0"]
    shared = np.arange(8, dtype=np.int32)
    reqs = [eng.submit("be0", shared, max_new=2)]
    while clock["t"] < 3.0:             # warm the tree before the window
        par.step(eng, clock)
    nodes_before = rt.prefix.stats()["nodes"]
    reqs.append(eng.submit("be0", shared, max_new=2))
    for _ in range(10):                 # inside the window: no admission
        par.step(eng, clock)
        assert reqs[1].phase in (s.sv.Phase.WAITING, s.sv.Phase.FINISHED) \
            or clock["t"] > 23.0
    assert rt.prefix.stats()["nodes"] >= nodes_before
    assert rt.kv.alloc_faults > 0
    par.drive(eng, clock)
    return eng, reqs


def test_alloc_fault_defers_admission_without_tree_flush(tiny):
    """An alloc_fail window defers paged admission (deferral, not
    eviction): nothing admits inside the window, the prefix tree keeps its
    nodes, and the workload completes once the window lifts."""
    ref, port, _ = par.run_both(tiny, _alloc_window)
    par.assert_same(ref, port)
    assert len(port["tokens"][1]) == 2


def test_grow_deadlock_sheds_instead_of_spinning(tiny):
    """Growth with every victim stuck SWAPPING: the deadlock is counted and
    a BE request shed so the pool drains."""
    # a long read-fault window with the retry escape disabled wedges the
    # swapped-in victim in SWAPPING while a later request tries to grow
    # past it; the window is finite so the wedged request recovers
    def scenario(s, clock):
        plane = _plane(s, [((0.0, "swap_read_fail"), {"duration": 400.0})])
        eng = _engine(s, clock, kv_pages=6, slots=2, faults=plane,
                      swap_retry_limit=10_000)
        reqs = [eng.submit("be0", p, max_new=16) for p in par.prompts(17, 3)]
        par.drive(eng, clock, stall_cap=3000)
        return eng, reqs
    ref, port, eng = par.run_both(tiny, scenario)
    par.assert_same(ref, port)
    rt = eng.tenants["be0"]
    assert rt.grow_deadlocks > 0
    assert rt.shed > 0
    for r in rt.done:                   # every request resolved, none lost
        assert r.phase is Phase.FINISHED
        assert r.shed or len(r.output) == 16


def test_deadline_sheds_expired_be_requests(tiny):
    def scenario(s, clock):
        eng = _engine(s, clock, kv_pages=6, slots=2)
        reqs = [eng.submit("be0", p, max_new=8) for p in par.prompts(21, 2)]
        reqs.append(eng.submit("be0", par.prompts(22, 1)[0], max_new=8,
                               deadline=0.5))
        clock["t"] = 2.0                # already past the deadline
        par.drive(eng, clock)
        return eng, reqs
    ref, port, eng = par.run_both(tiny, scenario)
    par.assert_same(ref, port)
    doomed = eng.tenants["be0"].done[0]
    assert doomed.shed and doomed.failed and doomed.output == []
    assert [len(t) for t in port["tokens"]] == [8, 8, 0]
    assert port["faults"]["shed"] == 1


def test_submit_validation_and_backpressure(tiny):
    def scenario(s, clock):
        eng = _engine(s, clock, max_queue=2)
        with pytest.raises(KeyError):
            eng.submit("nope", [1, 2, 3])
        with pytest.raises(ValueError):
            eng.submit("be0", [])
        with pytest.raises(ValueError):
            eng.submit("be0", np.zeros((2, 2), np.int32))
        reqs = [eng.submit("be0", np.zeros(MAX_SEQ + 1, np.int32))]
        reqs += [eng.submit("be0", p, max_new=2) for p in par.prompts(25, 2)]
        reqs.append(eng.submit("be0", par.prompts(26, 1)[0], max_new=2))
        par.drive(eng, clock)
        return eng, reqs
    ref, port, eng = par.run_both(tiny, scenario)
    par.assert_same(ref, port)
    assert [f[2] for f in port["flags"]] == [True, False, False, True]
    assert [f[0] for f in port["flags"]] == [True, False, False, True]
    assert port["tokens"] == [[], port["tokens"][1], port["tokens"][2], []]
    assert len(port["tokens"][1]) == 2 and len(port["tokens"][2]) == 2
    assert eng.tenants["be0"].rejected == 2
    assert port["faults"]["rejected"] == 2


def test_flash_to_dense_rung_keeps_tokens(tiny):
    """The first ladder rung rebuilds a flash tenant's forwards on the
    torch-op attention core mid-run (the CUDA kernels' plain versions on
    the CPU; the kernels on the card); tokens match the torch-op
    engine's."""
    s = par.side(tiny, "port")
    prompts = par.prompts(29, 2)
    _, clean = _serve(s, {"t": 0.0}, prompts=prompts, max_new=4,
                      kv_pages=None, swap=False, grow_pages=False)
    clock = {"t": 0.0}
    eng = _engine(s, clock, swap=False, grow_pages=False, use_flash=True,
                  fault_budget=1)
    rt = eng.tenants["be0"]
    assert rt.flash
    eng.backend._record_recovery(rt, "synthetic")
    assert not rt.flash and rt.degraded == ["flash_to_dense"]
    reqs = [eng.submit("be0", p, max_new=4) for p in prompts]
    par.drive(eng, clock)
    assert [r.output for r in reqs] == [r.output for r in clean]
    assert eng.metrics()["faults"]["degraded_tenants"] == {
        "be0": ["flash_to_dense"]}


# ---------------------------------------------------------------------------
# controller: missed ticks, stale signals, watchdog
# ---------------------------------------------------------------------------

def _watchdog_run(s, clock, *, recovery):
    lend = s.cm.ResourcePlan(1.0, 1.0, 0.5, (), (), 2.0)
    cons = s.cm.ResourcePlan(0.1, 1 / 6, 0.5, (), (), 2.0, prefill_budget=8)
    ctrl = s.cm.OnlineController(s.cm.PlanFrontier([(0.0, lend),
                                                    (1.0, cons)]),
                                 idle_patience=1)
    # healthy ticks before t=6 store the BE-only (zero LS load) signal;
    # the stale window then feeds that stored signal to decide() exactly
    # while the LS burst lands, and the missed-tick window keeps the
    # controller dark for the rest of the run
    plane = _plane(s, [((6.0, "ctl_stale_signal"), {"duration": 20.0}),
                       ((26.0, "ctl_missed_tick"), {"duration": 1e9})])
    eng = _engine(s, clock, tenants=("ls0", "be0"), swap=False,
                  grow_pages=False, controller=ctrl, control_interval=2,
                  faults=plane, fault_recovery=recovery)
    reqs = [eng.submit("be0", p, max_new=24)
            for p in par.prompts(33, 3, length=8)]
    # drain a little BE-only work so the controller lends everything
    par.step(eng, clock, 8)
    assert eng.sm_be == pytest.approx(1.0)
    reqs.append(eng.submit("ls0", par.prompts(34, 1, length=6)[0],
                           max_new=4))
    par.drive(eng, clock)
    return eng, reqs


def test_watchdog_bounds_ls_starvation_under_dead_controller(tiny):
    """With the controller's ticks dropped mid-lending, the watchdog snaps
    to the frontier's conservative plan within watchdog_quanta steps (as in
    the reference); the no-watchdog ablation leaves LS stuck behind the
    whole BE backlog."""
    ref, port, eng = par.run_both(tiny, _watchdog_run, recovery=True)
    par.assert_same(ref, port)
    assert eng.missed_ticks > 0 and eng.stale_signals > 0
    assert eng.watchdog_trips >= 1
    assert any(t.get("watchdog") for t in eng.transitions)
    assert eng.sm_be <= 0.1 + 1e-9
    ls = eng.tenants["ls0"].done[0]
    assert len(ls.output) == 4
    off, _ = _watchdog_run(par.side(tiny, "port"), {"t": 0.0},
                           recovery=False)
    ls_off = off.tenants["ls0"].done[0]
    assert off.watchdog_trips == 0 and len(ls_off.output) == 4
    assert ls.t_done - ls.t_submit < ls_off.t_done - ls_off.t_submit


# ---------------------------------------------------------------------------
# the oracle: surviving requests are bit-equal under any seeded storm
# ---------------------------------------------------------------------------

_ORACLE_STATS = {"injected": 0, "recovered": 0, "shed": 0}


def _storm_plane(seed):
    return lambda s: s.sv.FaultPlane.storm(
        horizon=300.0, seed=seed,
        rates={"swap_write_fail": 0.05, "swap_read_fail": 0.05,
               "page_corrupt": 0.05, "alloc_fail": 0.02},
        duration=8.0)


@given(seed=st.integers(0, 10_000))
@settings(max_examples=3, deadline=None)
def test_fault_interleaving_oracle(seed):
    """Any seeded storm may delay or shed requests, but every surviving
    request's tokens equal the fault-free run's; the port's faulted run
    equals the reference's."""
    tiny = par.tiny_models()
    prompts = par.prompts(seed, 4)
    clean = _clean(tiny, prompts, kv_pages=6)
    ref, port, _ = par.run_both(tiny, _serve, prompts=prompts, kv_pages=6,
                                faults=_storm_plane(seed))
    par.assert_same(ref, port)
    m = port["faults"]
    _ORACLE_STATS["injected"] += sum(m["injected"].values())
    _ORACLE_STATS["recovered"] += sum(m["recovered"].values())
    _ORACLE_STATS["shed"] += m["shed"]
    for c, r, f in zip(clean, port["tokens"], port["flags"]):
        assert f[0] or r == c, f"seed {seed}: surviving tokens diverged"


def test_oracle_not_vacuous():
    """Guard: the property above must actually have exercised injections
    across its examples — otherwise the bit-equality proves nothing."""
    assert _ORACLE_STATS["injected"] > 0
    assert _ORACLE_STATS["recovered"] + _ORACLE_STATS["shed"] >= 0


# ---------------------------------------------------------------------------
# one traced seeded run: the port's JSONL is the reference's, byte for byte
# ---------------------------------------------------------------------------

def _traced(s, clock, *, tracer):
    plane = s.sv.FaultPlane.storm(
        horizon=400.0, seed=3,
        rates={"swap_write_fail": 0.04, "swap_read_fail": 0.04,
               "page_corrupt": 0.06, "alloc_fail": 0.02}, duration=6.0)
    eng = _engine(s, clock, tenants=("ls0", "be0"), kv_pages=8,
                  prefix_cache=True, faults=plane, tracer=tracer,
                  specs={"ls0": {"slo_ms": 20_000.0}})
    rng = np.random.default_rng(41)
    base = rng.integers(0, 100, 10)
    reqs = []
    for i in range(10):
        t = ("ls0", "be0")[i % 2]
        toks = np.concatenate([base[:int(rng.integers(2, 11))],
                               rng.integers(0, 100, int(rng.integers(0, 4)))])
        reqs.append(eng.submit(t, toks.astype(np.int32),
                               max_new=int(rng.integers(3, 12)),
                               deadline=None if t == "ls0" else 400.0))
        par.step(eng, clock, int(rng.integers(0, 3)))
    par.drive(eng, clock, stall_cap=3000)
    return eng, reqs


def test_traced_hierarchy_storm_matches_reference(tiny, tmp_path):
    streams = []
    for name, mod in (("ref", jobs), ("port", obs), ("port", obs)):
        tr = mod.Tracer("debug")
        eng, reqs = _traced(par.side(tiny, name), {"t": 0.0}, tracer=tr)
        streams.append((tr.jsonl(), par.snapshot(eng, reqs)))
    assert streams[1][0] == streams[2][0]      # port replays byte-identical
    assert streams[1][0] == streams[0][0]      # and equals the reference
    par.assert_same(streams[0][1], streams[1][1])
    evs = [json.loads(ln) for ln in streams[1][0].splitlines()]
    jschema.validate_events(evs)
    path = tmp_path / "port.jsonl"
    path.write_text(streams[1][0])
    assert jschema._main([str(path)]) == 0
    kinds = {e["kind"] for e in evs}
    assert {"request", "phase", "quantum", "chunk", "swap", "fault",
            "recovery"} <= kinds
    snap = streams[1][1]
    assert snap["faults"]["recovered"]
    assert any(sw and sw["swap_outs"] for sw in
               (t["swap"] for t in snap["tenant"].values()))
    assert any(t["prefix_cache"]["hits"] for t in snap["tenant"].values())
