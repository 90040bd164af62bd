"""The port's control plane against the reference on the same inputs.

The host-side modules (``core.compute``, ``core.costmodel``,
``core.simulator``, ``core.controller``) are copies of the reference's, so
every comparison here is exact: load signals and compute policies on seeded
draws, ``model_costs`` for every registered config, ``GPUSimulator`` runs
on seeded traces for every device, the offline plan searches, and the
online controller, chunk governor and plan schedule on the same
``LoadSignal`` streams.

The engine half runs the port's ``ServingEngine`` with ``coloring=True``
(the 4-channel ``conftest.FakeHashModel``), an ``OnlineController`` and a
``ChunkGovernor`` next to the reference engine, with the same weights and
the same virtual clock (``now_fn`` steps one unit a quantum, so TBT and the
governor's decisions are equal on both sides): transitions, quantum order,
tokens, the arena's allocations after every step (name, shadow page table,
channels, isolation violations) and the control rollups of ``metrics()``
are equal. Plus port twins of ``tests/test_controller_online.py``'s engine
tests (lending and snap-back, lending widens BE admission, tokens
bit-equal across a mid-run resplit).

Weights come from the port's seeded init (``tf.init_params``), which has
the reference's tree and distribution and, unlike the reference's
``init_params`` (its per-leaf key folds in Python's per-process salted
``hash``), draws the same weights in every process; the reference gets
them through ``bridge.to_numpy``.
"""
import dataclasses
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from conftest import FakeHashModel  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro.core.compute as jcompute  # noqa: E402
import repro.core.controller as jctl  # noqa: E402
import repro.core.costmodel as jcost  # noqa: E402
import repro.core.simulator as jsim  # noqa: E402
from repro.core.tenancy import TenantSpec as JSpec  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
import repro_torch.configs as configs  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
import repro_torch.core.compute as compute  # noqa: E402
import repro_torch.core.controller as ctl  # noqa: E402
import repro_torch.core.costmodel as cost  # noqa: E402
import repro_torch.core.simulator as sim  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core.tenancy import TenantSpec  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serving import Phase, ServingEngine  # noqa: E402
from repro_torch.serving.kv_cache import kv_bytes_per_token  # noqa: E402

MAX_SEQ = 24


def _asdict(obj):
    """A dataclass (or a list/tuple of them) as plain data, so a port
    object compares equal to its reference twin."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _asdict(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_asdict(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _asdict(v) for k, v in obj.items()}
    return obj


# ---------------------------------------------------------------------------
# core.compute
# ---------------------------------------------------------------------------

def test_load_signal_and_compute_policy_match():
    rng = np.random.default_rng(0)
    for _ in range(200):
        kw = dict(ls_queued=int(rng.integers(0, 6)),
                  ls_active=int(rng.integers(0, 6)),
                  ls_slots=int(rng.integers(0, 5)),
                  ls_slo_attainment=(None if rng.random() < 0.3
                                     else float(rng.random())))
        a, b = jcompute.LoadSignal(**kw), compute.LoadSignal(**kw)
        assert a.ls_load == b.ls_load
        total, min_ls = int(rng.integers(1, 9)), int(rng.integers(0, 4))
        assert (jcompute.ElasticMeshPartitioner(total, min_ls)
                .rebalance_from_signal(a)
                == compute.ElasticMeshPartitioner(total, min_ls)
                .rebalance_from_signal(b))
    for kind in ("sgdrc", "temporal", "spatial", "orion", "multistream"):
        for _ in range(20):
            sm_be = float(rng.random())
            p, q = (jcompute.ComputePolicy(kind=kind, sm_be=sm_be),
                    compute.ComputePolicy(kind=kind, sm_be=sm_be))
            for ls in (False, True):
                for be in (False, True):
                    assert p.alloc(ls, be) == q.alloc(ls, be)
                assert p.preemption_delay(ls) == q.preemption_delay(ls)
            new = float(rng.uniform(-0.5, 1.5))
            assert p.update(new).sm_be == q.update(new).sm_be


# ---------------------------------------------------------------------------
# core.costmodel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(ARCHS))
def test_model_costs_match(name):
    jcfg, cfg = jconfigs.get_config(name), configs.get_config(name)
    for args, kw in [((1, 128, "prefill"), {}),
                     ((8, 256, "prefill"), {"chunk": 64, "prefix": 32}),
                     ((4, 512, "decode"), {"kv_write": "paged"}),
                     ((4, 512, "decode"), {"kv_write": "scatter",
                                           "swap_bytes": 4096}),
                     ((2, 64, "train"), {})]:
        assert (_asdict(cost.model_costs(cfg, *args, **kw))
                == _asdict(jcost.model_costs(jcfg, *args, **kw)))
    assert cost.step_costs(cfg, 2, 64, "train") == jcost.step_costs(
        jcfg, 2, 64, "train")
    for active in (False, True):
        assert (cost.param_count(cfg, active_only=active)
                == jcost.param_count(jcfg, active_only=active))
    assert (cost.kv_token_bytes(cfg) == jcost.kv_token_bytes(jcfg))


# ---------------------------------------------------------------------------
# core.simulator
# ---------------------------------------------------------------------------

def _sim_tenants(mod, cf, dev, seed):
    ls_k = mod.request_kernels(cf.get_config("qwen3-1.7b"), 1, 128,
                               "prefill", dev, chunk=32)
    be_k = mod.request_kernels(cf.get_config("gemma2-9b"), 8, 256,
                               "prefill", dev)
    return [mod.Tenant("ls0", "LS", ls_k,
                       arrivals=mod.poisson_trace(4, 1.0, seed),
                       prefill_kernels=4),
            mod.Tenant("ls1", "LS", ls_k,
                       arrivals=mod.apollo_like_trace(2, 1.0, seed + 1)),
            mod.Tenant("be0", "BE", be_k, closed_loop=True)]


def _sim_result(res):
    return [(tn.name, tn.completed, tn.latencies, tn.ttfts, tn.tbt_gaps)
            for tn in res.tenants]


@pytest.mark.parametrize("device", sorted(sim.GPU_DEVICES))
def test_simulator_matches(device):
    """Seeded traces, then a static and a controller-driven run of
    ``GPUSimulator`` per policy: per-tenant completions, latencies, TTFTs
    and TBT gaps equal."""
    jdev, dev = jsim.GPU_DEVICES[device], sim.GPU_DEVICES[device]
    assert dataclasses.asdict(jdev) == dataclasses.asdict(dev)
    assert sim.poisson_trace(40, 0.5, 3) == jsim.poisson_trace(40, 0.5, 3)
    seed = sorted(sim.GPU_DEVICES).index(device)
    for kind, coloring in (("sgdrc", True), ("temporal", False),
                           ("orion", False)):
        out = []
        for mod, cmp, cf in ((jsim, jcompute, jconfigs),
                             (sim, compute, configs)):
            d = mod.GPU_DEVICES[device]
            s = mod.GPUSimulator(d, cmp.ComputePolicy(kind=kind),
                                 coloring=coloring)
            out.append(_sim_result(s.run(_sim_tenants(mod, cf, d, seed),
                                         1.0)))
        assert out[0] == out[1]
    out = []
    for mod, cmp, cm, cf in ((jsim, jcompute, jctl, jconfigs),
                             (sim, compute, ctl, configs)):
        d = mod.GPU_DEVICES[device]
        ctrl = cm.OnlineController(cm.tidal_frontier(
            _plan(cm, 0.3, 1 / 3, d.num_channels), d.num_channels),
            idle_patience=1)
        s = mod.GPUSimulator(d, cmp.ComputePolicy(kind="sgdrc"),
                             coloring=True, controller=ctrl,
                             migration_bytes=1 << 20)
        res = s.run(_sim_tenants(mod, cf, d, seed), 1.0)
        out.append((_sim_result(res), s.migrated_bytes,
                    [(t, _asdict(p)) for t, p in ctrl.transitions]))
    assert out[0] == out[1]
    assert out[1][2], "the controller never moved"


# ---------------------------------------------------------------------------
# core.controller: offline search and online decisions
# ---------------------------------------------------------------------------

def _plan(mod, sm_be=0.3, ch_be=0.25, C=4, **kw):
    n_be = max(1, int(round(C * ch_be)))
    return mod.ResourcePlan(sm_be, ch_be, 0.4, tuple(range(C - n_be)),
                            tuple(range(C - n_be, C)), 1.2, **kw)


def test_plan_searches_match():
    out = []
    for cm, cf, sm in ((jctl, jconfigs, jsim), (ctl, configs, sim)):
        dev = sm.GPU_DEVICES["tesla-p40"]
        ls, be = [cf.smoke_config("qwen3-1.7b")], [cf.smoke_config(
            "gemma2-9b")]
        grid = cm.grid_search(dev, ls, be, sm_grid=(0.2, 0.4),
                              ch_grid=(1 / 4, 1 / 3), thres_grid=(0.4,),
                              pairs_per_model=2, prefill_budget=64)
        front = cm.frontier_search(dev, ls, be, load_grid=(0.5, 1.0),
                                   pairs_per_model=1, sm_grid=(0.2, 0.4),
                                   ch_grid=(1 / 4,), thres_grid=(0.4,),
                                   prefix_hit=0.25, swap_quantum_pages=2)
        base = _plan(cm, prefill_budget=32, swap_quantum_pages=3)
        out.append({
            "grid": _asdict(grid),
            "frontier": [(load, _asdict(p)) for load, p in front.entries],
            "tidal": [(load, _asdict(p)) for load, p in
                      cm.tidal_frontier(base, 4).entries],
            "lend": _asdict(cm.lending_plan(base, 12)),
            "mem": cm.memory_bound_ops(cf.get_config("qwen3-1.7b"), 4, 256,
                                       "decode", dev, 0.4)})
    assert out[0] == out[1]


def _signals(seed, n=300):
    """A seeded LoadSignal stream with idle stretches (so the controller
    lends), tides and SLO dips."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        idle = (i // 7) % 3 == 0
        q = 0 if idle else int(rng.integers(0, 5))
        a = 0 if idle else int(rng.integers(0, 5))
        slo = None if rng.random() < 0.4 else float(rng.uniform(0.9, 1.0))
        tbt = None if rng.random() < 0.2 else float(rng.uniform(1, 40))
        out.append(dict(ls_queued=q, ls_active=a, ls_slots=4,
                        ls_slo_attainment=slo, ls_tbt_p99_ms=tbt))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_online_decisions_match(seed):
    """OnlineController (over a 3-regime frontier), ChunkGovernor and
    PlanSchedule make the same decisions on the same LoadSignal stream."""
    sigs = _signals(seed)
    out = []
    for cm, cmp in ((jctl, jcompute), (ctl, compute)):
        lend = cm.lending_plan(_plan(cm), 4)
        front = cm.PlanFrontier([(0.0, lend), (0.5, _plan(cm, 0.5, 0.5)),
                                 (1.0, _plan(cm, 0.1, 0.25))])
        oc = cm.OnlineController(front, idle_patience=2, slo_guard=0.95)
        gov = cm.ChunkGovernor(target_tbt_ms=20.0, chunk=64, min_chunk=8,
                               max_chunk=256, patience=2)
        sched = cm.PlanSchedule([(50.0, _plan(cm, 0.5, 0.5)),
                                 (0.0, _plan(cm)), (120.0, lend)])
        trace = []
        for t, kw in enumerate(sigs):
            sig = cmp.LoadSignal(**kw)
            p = oc.decide(sig, t=float(t))
            g = gov.update(sig.ls_tbt_p99_ms)
            s = sched.decide(sig, t=float(t))
            trace.append((front.index_of(p), oc.last_cause, g,
                          _asdict(s), sched.last_cause))
        out.append((trace, gov.stats(), gov.history,
                    [(t, front.index_of(p)) for t, p in oc.transitions],
                    len(sched.transitions)))
    assert out[0] == out[1]
    causes = {c for _, c, *_ in out[1][0]}
    assert {"lending", "snap_back", "slo_guard"} <= causes


# ---------------------------------------------------------------------------
# the serving engine's control path against the reference engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """1-layer f32 stablelm: (reference cfg, port cfg, reference params,
    port params), the same seeded weights on both sides."""
    name = "stablelm-1.6b"
    jcfg = jconfigs.smoke_config(name).replace(num_layers=1,
                                                activation_dtype="float32")
    cfg = configs.smoke_config(name).replace(num_layers=1,
                                             activation_dtype="float32")
    tp = tf.init_params(cfg, 7, "cpu")
    return jcfg, cfg, jax.tree.map(jnp.asarray, bridge.to_numpy(tp)), tp


def _side(tiny, side):
    jcfg, cfg, jp, tp = tiny
    if side == "ref":
        return SimpleNamespace(Engine=JEngine, Spec=JSpec, cm=jctl, cfg=jcfg,
                               params=jp, kw={})
    return SimpleNamespace(Engine=ServingEngine, Spec=TenantSpec, cm=ctl,
                           cfg=cfg, params=tp, kw={"torch_device": "cpu"})


def _arena_state(eng):
    a = eng.arena
    return [(n, al.spt.tolist(), tuple(al.channels),
             a.isolation_violations(al))
            for n, al in a.allocations.items()] if a is not None else None


def _idle(eng):
    return not any(rt.has_work() for rt in eng.tenants.values())


def _tidal_run(tiny, side, case):
    """One seeded LS+BE run on one side. ``case``: "online" (paged,
    colored, OnlineController; an LS tide is submitted four quanta after
    the lending plan first comes in force, once BE has admitted onto LS
    channels),
    "governor" (paged, ChunkGovernor only), "dense" (whole-row coloring
    under the controller, one arena group per tenant)."""
    s = _side(tiny, side)
    cm = s.cm
    clock = {"t": 0.0}
    plan = _plan(cm)
    kw = dict(max_seq=MAX_SEQ, plan=plan, slots_ls=4, slots_be=6,
              now_fn=lambda: clock["t"], control_interval=2, **s.kw)
    if case in ("online", "dense"):
        kw.update(coloring=True, hash_model=FakeHashModel(),
                  controller=cm.OnlineController(cm.tidal_frontier(plan, 4),
                                                 idle_patience=1))
    if case == "online":
        kw.update(arena_bytes=10 * kv_bytes_per_token(s.cfg) * MAX_SEQ,
                  chunk_size=4, paged=True, page_size=4)
    elif case == "dense":
        kw.update(arena_bytes=16 * kv_bytes_per_token(s.cfg) * MAX_SEQ)
    else:
        kw.update(paged=True, page_size=4, chunk_size=8,
                  chunk_governor=cm.ChunkGovernor(
                      target_tbt_ms=1500.0, chunk=8, min_chunk=1,
                      max_chunk=8, patience=2))
    eng = s.Engine(**kw)
    eng.add_tenant(s.Spec("ls0", "LS", slo_ms=300_000.0), s.cfg,
                   params=s.params)
    eng.add_tenant(s.Spec("be0", "BE"), s.cfg, params=s.params)
    rng = np.random.default_rng(11)
    reqs = [eng.submit("ls0", rng.integers(0, 100, int(rng.integers(4, 9))),
                       max_new=6) for _ in range(3)]
    reqs += [eng.submit("be0", rng.integers(0, 100, int(rng.integers(8, 16))),
                        max_new=8) for _ in range(8)]
    tide = [rng.integers(0, 100, int(rng.integers(4, 9))) for _ in range(2)]
    arena, lent_at = [], None
    for _ in range(2000):
        clock["t"] += 1.0
        if lent_at is None and eng.sm_be >= 1.0:
            lent_at = eng._step_idx
        if lent_at is not None and eng._step_idx == lent_at + 4:
            reqs += [eng.submit("ls0", p, max_new=6) for p in tide]
        progressed = eng.step()
        arena.append(_arena_state(eng))
        if not progressed and _idle(eng):
            break
    if lent_at is None:            # the governor case never lends
        reqs += [eng.submit("ls0", p, max_new=6) for p in tide]
        eng.run_until_idle()
    m = eng.metrics()
    return dict(tokens=[[int(x) for x in r.output] for r in reqs],
                transitions=eng.transitions, events=eng.events,
                arena=arena, lent_at=lent_at,
                metrics={k: m.get(k) for k in ("_online", "_coloring",
                                                "_chunk_governor",
                                                "_registry")},
                chunk=eng.scheduler.chunk_size,
                slots={n: rt.n_slots for n, rt in eng.tenants.items()})


@pytest.mark.parametrize("case", ["online", "governor", "dense"])
def test_engine_control_matches_reference(tiny, case):
    ref = _tidal_run(tiny, "ref", case)
    port = _tidal_run(tiny, "port", case)
    for key in ref:
        assert port[key] == ref[key], key
    assert all(len(t) in (6, 8) for t in port["tokens"])
    causes = {t["cause"] for t in port["transitions"]}
    if case == "governor":
        assert causes == {"chunk_adapt"} and port["chunk"] < 8
        return
    assert {"initial", "lending", "snap_back"} <= causes
    # the tide arrived while BE held pages on LS channels: the snap-back
    # left them off-color (BE's own channel was full), later ticks drained
    # them as BE pages freed up (bytes charged, nothing copied), and no LS
    # group ever sat off its colors
    if case == "online":
        viol = [(n, v) for st in port["arena"] for n, _, _, v in st if v]
        assert viol and all(n.startswith("be0") for n, _ in viol)
        assert port["metrics"]["_online"]["migrated_bytes"] > 0
    else:
        assert port["slots"]["be0"] < 6      # BE rows capped by its colors


# ---------------------------------------------------------------------------
# port twins of tests/test_controller_online.py's engine tests
# ---------------------------------------------------------------------------

def _paged_engine(cfg, *, controller=None, rows=10, plan=None,
                  slots_be=6, control_interval=2):
    plan = plan or _plan(ctl)
    return ServingEngine(
        max_seq=MAX_SEQ, coloring=True, plan=plan, paged=True, page_size=4,
        hash_model=FakeHashModel(),
        arena_bytes=rows * kv_bytes_per_token(cfg) * MAX_SEQ,
        slots_ls=4, slots_be=slots_be, controller=controller,
        control_interval=control_interval, torch_device="cpu")


def test_engine_online_lends_and_snaps_back(tiny):
    _, cfg, _, tp = tiny
    rng = np.random.default_rng(0)
    oc = ctl.OnlineController(ctl.tidal_frontier(_plan(ctl), 4),
                              idle_patience=1)
    eng = _paged_engine(cfg, controller=oc)
    eng.add_tenant(TenantSpec("ls0", "LS", slo_ms=300_000.0), cfg, params=tp)
    eng.add_tenant(TenantSpec("be0", "BE"), cfg, params=tp)
    for _ in range(2):
        eng.submit("ls0", rng.integers(0, 100, 6), max_new=3)
    for _ in range(6):
        eng.submit("be0", rng.integers(0, 100, 6), max_new=10)
    # run to idle, then inject a second LS tide against the lending plan
    eng.run_until_idle()
    assert any(t["sm_be"] == 1.0 for t in eng.transitions), "never lent"
    assert eng.sm_be == 1.0
    eng.submit("ls0", rng.integers(0, 100, 6), max_new=3)
    eng.step()    # out-of-band control tick precedes the quantum
    assert eng.sm_be < 1.0, "no snap-back on LS arrival"
    assert [t for t in eng.transitions if t["sm_be"] < 1.0]
    eng.run_until_idle()
    m = eng.metrics()
    assert m["ls0"]["completed"] == 3 and m["be0"]["completed"] == 6
    assert m["_class"]["LS"]["slo_attainment"] == 1.0
    assert m["_online"]["transitions"] == len(eng.transitions)
    # LS allocations never migrate: zero violations across the tide
    for name, a in eng.arena.allocations.items():
        if name.startswith("ls0"):
            assert eng.arena.isolation_violations(a) == 0, name


def test_engine_lending_widens_be_admission(tiny):
    """Static BE admission is capped by its channel set's colored bytes;
    the tidal resplit lets BE borrow idle LS channels and batch wider."""
    _, cfg, _, tp = tiny
    results = {}
    for mode in ("static", "online"):
        oc = (ctl.OnlineController(ctl.tidal_frontier(_plan(ctl), 4),
                                   idle_patience=1)
              if mode == "online" else None)
        eng = _paged_engine(cfg, controller=oc, rows=10)
        eng.add_tenant(TenantSpec("be0", "BE"), cfg, params=tp)
        r = np.random.default_rng(0)
        for _ in range(6):
            eng.submit("be0", r.integers(0, 100, 6), max_new=8)
        quanta = eng.run_until_idle()
        m = eng.metrics()
        assert m["be0"]["completed"] == 6
        results[mode] = (m["be0"]["peak_active"], quanta)
    # 10-row arena, 1-of-4 BE channels -> ~2 static rows; lending opens it up
    assert results["static"][0] <= 3
    assert results["online"][0] > results["static"][0]
    assert results["online"][1] < results["static"][1]   # fewer quanta


def test_engine_tokens_bit_equal_across_midrun_resplit(tiny):
    """The bimodal-tensor switch is placement bookkeeping only: a mid-run
    ch_be move (arena resplit + KV recolor) changes no token, and the
    device pools are the same tensors before and after."""
    _, cfg, _, tp = tiny
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 100, 6) for _ in range(6)]

    def run(resplit_at):
        eng = _paged_engine(cfg, rows=24, plan=_plan(ctl, 0.3, 0.25))
        eng.add_tenant(TenantSpec("ls0", "LS"), cfg, params=tp)
        eng.add_tenant(TenantSpec("be0", "BE"), cfg, params=tp)
        reqs = [eng.submit("ls0" if i % 3 == 0 else "be0", p, max_new=6)
                for i, p in enumerate(prompts)]
        steps = 0
        while eng.step():
            steps += 1
            if steps == resplit_at:
                pools = [(rt.cache["layers"]["s0"]["k"].data_ptr(),
                          rt.kv.device_page_table().data_ptr())
                         for rt in eng.tenants.values()]
                eng.apply_plan(_plan(ctl, 0.3, 0.5))  # pure channel move
                assert pools == [
                    (rt.cache["layers"]["s0"]["k"].data_ptr(),
                     rt.kv.device_page_table().data_ptr())
                    for rt in eng.tenants.values()]
        assert all(r.phase is Phase.FINISHED for r in reqs)
        return eng, [r.output for r in reqs]

    eng_a, out_a = run(resplit_at=None)
    eng_b, out_b = run(resplit_at=3)
    assert eng_b.transitions and eng_b.transitions[0]["ch_be"] == 0.5
    assert eng_b.transitions[0]["pages_moved"] > 0
    assert out_a == out_b
    # and the resplit left every allocation on its (new) color
    for name, a in eng_b.arena.allocations.items():
        assert eng_b.arena.isolation_violations(a) == 0, name


def test_dense_coloring_out_of_colored_memory(tiny):
    """Whole-row coloring raises when the class's colors cannot hold one
    KV row, as the reference does."""
    _, cfg, _, tp = tiny
    from repro_torch.core.coloring import OutOfColoredMemory
    eng = ServingEngine(max_seq=MAX_SEQ, coloring=True,
                        hash_model=FakeHashModel(),
                        arena_bytes=2 * kv_bytes_per_token(cfg) * MAX_SEQ,
                        torch_device="cpu")
    with pytest.raises(OutOfColoredMemory):
        eng.add_tenant(TenantSpec("be0", "BE"), cfg, params=tp)
