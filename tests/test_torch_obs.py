"""The port's telemetry plane against the reference.

``SLOTimeline`` (a copy of ``repro.obs.timeline``) gives the same report
as the reference's on the same seeded event streams, and port twins of
``tests/test_obs.py``'s timeline-attribution and plan-cause tests. Then
the determinism contract end to end: one seeded LS+BE run of the port's
engine under an ``OnlineController``, a ``ChunkGovernor`` and colored KV
pools, on a virtual clock, traced at ``debug``:

- its JSONL passes the reference's schema checker (``repro.obs.schema``,
  both ``validate_events`` and the ``python -m repro.obs.schema`` entry);
- it is byte-equal to the reference engine's JSONL for the same run;
- a second port run repeats it byte for byte;
- the traced run's tokens equal the untraced run's.

Weights come from the port's seeded init on both sides (see
``tests/test_torch_controller.py``).
"""
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from conftest import FakeHashModel  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro.core.controller as jctl  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro.obs import schema as jschema  # noqa: E402
from repro.core.tenancy import TenantSpec as JSpec  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
import repro_torch.configs as configs  # noqa: E402
import repro_torch.core.controller as ctl  # noqa: E402
from repro_torch import bridge, obs  # noqa: E402
from repro_torch.core.compute import LoadSignal  # noqa: E402
from repro_torch.core.tenancy import TenantSpec  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.serving.kv_cache import kv_bytes_per_token  # noqa: E402

MAX_SEQ = 32
PAGE = 4


# ---------------------------------------------------------------------------
# SLO timeline
# ---------------------------------------------------------------------------

def _stream(seed, n=200):
    """A seeded schema-valid stream: request done instants (met, violated,
    no SLO) and cause events (fault, plan, recovery, swap) on one clock."""
    rng = np.random.default_rng(seed)
    evs, t = [], 0.0
    for i in range(n):
        t += float(rng.exponential(0.3))
        r = rng.random()
        if r < 0.6:
            ok = [True, False, None][int(rng.integers(0, 3))]
            evs.append({"t": t, "ph": "I", "kind": "request", "name": "done",
                        "track": "slo",
                        "args": {"rid": i, "tenant": "ls0", "ok": ok,
                                 "t_submit": t - float(rng.uniform(0, 3))}})
        else:
            kind, name, args = [
                ("fault", "alloc_fail", {"target": "be0"}),
                ("plan", "snap_back", {"sm_be": 0.3, "ch_be": 0.25}),
                ("plan", "lending", {"sm_be": 1.0, "ch_be": 1.0}),
                ("recovery", "watchdog", {}),
                ("swap", "out", {"bytes": 4096, "direction": "out"}),
            ][int(rng.integers(0, 5))]
            evs.append({"t": t, "ph": "I", "kind": kind, "name": name,
                        "track": kind, "args": dict(args, step=i)})
    return evs


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("window", [None, 2.5])
def test_slo_timeline_report_matches(seed, window):
    evs = _stream(seed)
    jobs.validate_events(evs)
    a = jobs.SLOTimeline(evs, window=window, top_k=4)
    b = obs.SLOTimeline(evs, window=window, top_k=4)
    assert b.report() == a.report()
    assert b.format_table() == a.format_table()
    assert b.all_violations_attributed() == a.all_violations_attributed()
    assert b.violation_windows()


def _done(t, rid, ok, t_submit):
    return {"t": t, "ph": "I", "kind": "request", "name": "done",
            "track": "slo", "args": {"rid": rid, "tenant": "ls0", "ok": ok,
                                     "t_submit": t_submit}}


def test_slo_timeline_attributes_overlapping_causes():
    evs = [
        {"t": 4.0, "ph": "I", "kind": "fault", "name": "alloc_fail",
         "track": "faults", "args": {"target": "be0", "magnitude": 1.0,
                                     "duration": 2.0}},
        _done(3.0, 1, True, 1.0),
        _done(6.0, 2, False, 3.5),       # fault at 4.0 inside [3.5, 6.0]
        _done(20.0, 3, False, 18.0),     # nothing overlaps: unattributed
        _done(21.0, 4, None, 19.0),      # no SLO: excluded from attainment
    ]
    tl = obs.SLOTimeline(evs, window=10.0)
    assert tl.overall_attainment == pytest.approx(1 / 3)
    wins = tl.violation_windows()
    assert len(wins) == 2
    assert ("fault:alloc_fail", 1) in wins[0]["causes"]
    assert wins[1]["causes"] == [("unattributed", 1)]
    assert not tl.all_violations_attributed()
    attributed = obs.SLOTimeline(evs[:3], window=10.0)
    assert attributed.all_violations_attributed()
    assert "fault:alloc_fail" in attributed.format_table()


def test_controller_last_cause_taxonomy():
    lend = ctl.ResourcePlan(1.0, 1.0, 0.5, (), (), 2.0)
    mid = ctl.ResourcePlan(0.5, 0.5, 0.5, (), (), 2.0)
    cons = ctl.ResourcePlan(0.1, 1 / 6, 0.5, (), (), 2.0)
    oc = ctl.OnlineController(ctl.PlanFrontier([(0.0, lend), (0.5, mid),
                                                (1.0, cons)]),
                              idle_patience=1)
    busy = LoadSignal(ls_queued=4, ls_active=2, ls_slots=2)
    idle = LoadSignal(ls_queued=0, ls_active=0, ls_slots=2)
    half = LoadSignal(ls_queued=0, ls_active=1, ls_slots=2)
    slo = LoadSignal(ls_queued=0, ls_active=1, ls_slots=2,
                     ls_slo_attainment=0.5)
    expect = [(half, "hysteresis"), (idle, "lending"), (busy, "snap_back"),
              (idle, "hysteresis"), (slo, "slo_guard"), (slo, None)]
    for t, (sig, cause) in enumerate(expect):
        oc.decide(sig, float(t))
        assert oc.last_cause == cause
        assert cause is None or cause in obs.PLAN_CAUSES


# ---------------------------------------------------------------------------
# the traced engine run
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    name = "stablelm-1.6b"
    jcfg = jconfigs.smoke_config(name).replace(num_layers=1,
                                                activation_dtype="float32")
    cfg = configs.smoke_config(name).replace(num_layers=1,
                                             activation_dtype="float32")
    tp = tf.init_params(cfg, 7, "cpu")
    return jcfg, cfg, jax.tree.map(jnp.asarray, bridge.to_numpy(tp)), tp


def _prompts(seed, n, length):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 100, length).astype(np.int32) for _ in range(n)]


def _run(tiny, side, tracer=None):
    """LS+BE under a two-regime controller (lending / conservative with a
    BE prefill budget), a chunk governor and colored paged KV, one virtual
    clock unit a quantum; a second LS wave arrives mid-run."""
    jcfg, cfg, jp, tp = tiny
    ref = side == "ref"
    cm, Eng, Spec = (jctl, JEngine, JSpec) if ref else (ctl, ServingEngine,
                                                        TenantSpec)
    c, p = (jcfg, jp) if ref else (cfg, tp)
    lend = cm.ResourcePlan(1.0, 1.0, 0.5, (), (), 2.0)
    cons = cm.ResourcePlan(0.3, 1 / 4, 0.5, (), (), 2.0, prefill_budget=8)
    clock = {"t": 0.0}
    eng = Eng(max_seq=MAX_SEQ, paged=True, page_size=PAGE, chunk_size=PAGE,
              slots_ls=2, slots_be=3, coloring=True,
              hash_model=FakeHashModel(),
              arena_bytes=10 * kv_bytes_per_token(c) * MAX_SEQ,
              controller=cm.OnlineController(
                  cm.PlanFrontier([(0.0, lend), (1.0, cons)]),
                  idle_patience=1),
              chunk_governor=cm.ChunkGovernor(
                  target_tbt_ms=1500.0, chunk=PAGE, min_chunk=1,
                  max_chunk=8),
              control_interval=2, now_fn=lambda: clock["t"], tracer=tracer,
              **({} if ref else {"torch_device": "cpu"}))
    eng.add_tenant(Spec("ls0", "LS", slo_ms=4000.0), c, params=p)
    eng.add_tenant(Spec("be0", "BE"), c, params=p)
    reqs = [eng.submit("ls0", q, max_new=4) for q in _prompts(11, 3, 6)]
    reqs += [eng.submit("be0", q, max_new=12) for q in _prompts(12, 4, 9)]
    for i in range(4000):
        clock["t"] += 1.0
        if i == 20:
            reqs += [eng.submit("ls0", q, max_new=4)
                     for q in _prompts(13, 2, 5)]
        if not eng.step() and i > 20 and not any(
                rt.has_work() for rt in eng.tenants.values()):
            break
    return eng, [[int(x) for x in (r.output or [])] for r in reqs]


def test_traced_run_matches_reference(tiny, tmp_path):
    _, base = _run(tiny, "port")
    streams, outs = [], []
    for side in ("ref", "port", "port"):
        tr = (jobs if side == "ref" else obs).Tracer("debug")
        eng, toks = _run(tiny, side, tracer=tr)
        streams.append(tr.jsonl())
        outs.append(toks)
    assert outs[1] == base                     # tracing is pure observation
    assert outs[0] == outs[1] == outs[2]
    assert streams[1] == streams[2]            # port replays byte-identical
    assert streams[1] == streams[0]            # and equal to the reference
    evs = [json.loads(ln) for ln in streams[1].splitlines()]
    jschema.validate_events(evs)
    path = tmp_path / "port.jsonl"
    path.write_text(streams[1])
    assert jschema._main([str(path)]) == 0
    kinds = {e["kind"] for e in evs}
    assert {"request", "phase", "quantum", "chunk", "plan", "gauge"} <= kinds
    causes = {e["name"] for e in evs if e["kind"] == "plan"}
    assert {"initial", "lending", "snap_back", "chunk_adapt"} <= causes
    # the stream's plan instants are the engine's transitions, in order
    plans = [e for e in evs if e["kind"] == "plan"]
    assert [(e["name"], e["args"]["step"]) for e in plans] == [
        (t["cause"], t["step"]) for t in eng.transitions]
    snap = eng.registry.snapshot()
    assert {"measured_prefix_hit", "ls_load"} <= set(snap["gauges"])
    m = eng.metrics()
    assert m["_trace"]["events"] == len(evs)
    tl = obs.SLOTimeline(evs)
    assert tl.report() == jobs.SLOTimeline(evs).report()
    assert tl.overall_attainment is not None
