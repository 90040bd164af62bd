"""The engine-parity harness of the port's KV-hierarchy and fault tests
(``test_torch_prefix_cache.py``, ``test_torch_kv_hierarchy.py``,
``test_torch_faults.py``): one seeded scenario built on either side — the
reference engine (``repro.serving``) or the port's (``repro_torch.serving``,
``torch_device="cpu"``) — with the same weights (the port's seeded init,
given to the reference through ``bridge.to_numpy``; the reference's own
init salts its keys per process) and one virtual clock that steps one unit
a quantum, and a snapshot of everything the two must agree on.
:func:`family_models` and :func:`side_of` give each tenant a model of its
own (the MoE and MLA families' engine tests)."""
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.configs as jconfigs
import repro.core.controller as jctl
import repro.serving as jserving
from repro.core.tenancy import TenantSpec as JSpec
import repro_torch.configs as configs
import repro_torch.core.controller as ctl
import repro_torch.serving as serving
from repro_torch import bridge
from repro_torch.core.tenancy import TenantSpec
from repro_torch.models import transformer as tf
from repro_torch.serving.swap import _page_crc


@functools.lru_cache(maxsize=None)
def tiny_models(seed: int = 7):
    """1-layer f32 stablelm on both sides: (reference cfg, port cfg,
    reference params, port params), the same weights."""
    name = "stablelm-1.6b"
    jcfg = jconfigs.smoke_config(name).replace(num_layers=1,
                                                activation_dtype="float32")
    cfg = configs.smoke_config(name).replace(num_layers=1,
                                             activation_dtype="float32")
    tp = tf.init_params(cfg, seed, "cpu")
    return jcfg, cfg, jax.tree.map(jnp.asarray, bridge.to_numpy(tp)), tp


def family_models(names, seed: int = 7):
    """{name: (reference cfg, port cfg, reference params, port params)}
    for the f32 smoke configs of ``names``, the same weights on both
    sides."""
    out = {}
    for name in names:
        cfg = configs.smoke_config(name)
        tp = tf.init_params(cfg, seed, "cpu")
        out[name] = (jconfigs.smoke_config(name), cfg,
                     jax.tree.map(jnp.asarray, bridge.to_numpy(tp)), tp)
    return out


def side(tiny, name: str) -> SimpleNamespace:
    """Everything one side's scenario needs: its engine, tenant spec,
    serving and controller modules, config and weights."""
    jcfg, cfg, jp, tp = tiny
    if name == "ref":
        return SimpleNamespace(Engine=jserving.ServingEngine,
                               Spec=JSpec, sv=jserving, cm=jctl, cfg=jcfg,
                               params=jp, kw={}, models={})
    return SimpleNamespace(Engine=serving.ServingEngine,
                           Spec=TenantSpec, sv=serving, cm=ctl, cfg=cfg,
                           params=tp, kw={"torch_device": "cpu"}, models={})


def side_of(models, tenant_models, name: str) -> SimpleNamespace:
    """:func:`side` with a model a tenant: ``tenant_models`` maps a tenant
    name to a key of ``models`` (from :func:`family_models`)."""
    s = side(next(iter(models.values())), name)
    i = 0 if name == "ref" else 1
    s.models = {t: (models[m][i], models[m][i + 2])
                for t, m in tenant_models.items()}
    return s


def build(s, clock, *, tenants=("be0",), specs=None, **kw):
    """An engine on ``clock`` with tenants named ``ls*`` (LS) or ``be*``
    (BE); ``specs`` overrides a tenant's TenantSpec keywords. A tenant
    in ``s.models`` gets its own config and weights."""
    eng = s.Engine(now_fn=lambda: clock["t"], **s.kw, **kw)
    for name in tenants:
        pri = "LS" if name.startswith("ls") else "BE"
        cfg, params = s.models.get(name, (s.cfg, s.params))
        eng.add_tenant(s.Spec(name, pri, **(specs or {}).get(name, {})),
                       cfg, params=params)
    return eng


def step(eng, clock, n: int = 1):
    for _ in range(n):
        clock["t"] += 1.0
        eng.step()


def drive(eng, clock, cap: int = 6000, stall_cap: int = 600):
    """Run to idle on the virtual clock: a step that makes no progress
    inside a fault window (a deferral) ends the run only once no tenant
    has work left."""
    stall = 0
    for _ in range(cap):
        clock["t"] += 1.0
        if eng.step():
            stall = 0
        else:
            if not any(rt.has_work() for rt in eng.tenants.values()):
                return
            stall += 1
            assert stall < stall_cap, "engine wedged inside a fault window"
    raise AssertionError("workload did not drain")


def snapshot(eng, reqs) -> dict:
    """What the two engines must agree on after a run (each host page's
    CRC is held to its own bytes here; its bytes against the reference's
    in :func:`assert_same`)."""
    m = eng.metrics()
    names = list(eng.tenants)
    out = {
        "tokens": [None if r.output is None else [int(x) for x in r.output]
                   for r in reqs],
        "flags": [(r.failed, r.shed, r.rejected, r.hit_tokens, r.preempts)
                  for r in reqs],
        "events": [tuple(e) for e in eng.events],
        "quanta": [(q.tenant, q.priority, q.budget, q.decode_tokens,
                    q.prefill_tokens, q.swap_in_pages, q.swap_out_pages)
                   for q in eng.quantum_log],
        "transitions": eng.transitions,
        "tenant": {t: {k: m[t].get(k) for k in
                       ("completed", "failed", "peak_active", "kv_pages",
                        "prefix_cache", "swap", "prefill_tokens", "faults")}
                   for t in names},
        "faults": m.get("faults"),
        "registry": m.get("_registry"),
        "host": {t: [(k, hp.nbytes, hp.crc == _page_crc(hp.leaves))
                     for k, hp in rt.host.pages.items()]
                 for t, rt in eng.tenants.items() if rt.host is not None},
        "host_pages": {t: [(hp.leaves, hp.scales)
                           for hp in rt.host.pages.values()]
                       for t, rt in eng.tenants.items()
                       if rt.host is not None},
        "tree": {t: rt.prefix.stats() for t, rt in eng.tenants.items()
                 if rt.prefix is not None},
        "fault_log": (None if eng.faults is None else
                      [dict(e) for e in eng.faults.log]),
    }
    return out


def _pcie_s(snap):
    """Pop every ``pcie_s`` out of a snapshot (a float sum over the logged
    copies) so it can be compared at a relative tolerance."""
    got = []
    for t in snap["tenant"].values():
        sw = t.get("swap")
        if sw and "host" in sw:
            got.append(sw["host"].pop("pcie_s"))
    return got


def _assert_pages_close(ref, port, tol=1e-5):
    """Host pages of the two engines: the K/V the two frameworks computed
    agree to f32 rounding, not bit for bit, so neither do the pages' bytes
    or CRCs. fp16 pages within (``tol``, ``tol``); int8 pages' scales
    within 1e-5 relative and their codes within one step."""
    assert len(port) == len(ref)
    for (pl, ps), (rl, rs) in zip(port, ref):
        assert (ps is None) == (rs is None) and len(pl) == len(rl)
        if ps is not None:
            assert ps == pytest.approx(rs, rel=1e-5, abs=1e-12)
        for a, b in zip(pl, rl):
            b = np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            if ps is None:
                np.testing.assert_allclose(a, b, rtol=tol, atol=tol)
            else:
                d = np.abs(a.astype(np.int16) - b.astype(np.int16))
                assert d.max(initial=0) <= 1


def assert_same(ref: dict, port: dict, page_tol: float = 1e-5):
    """Everything equal, host pages within ``page_tol`` (a deeper model's
    K/V drift more: its test states its own)."""
    ref_p, port_p = _pcie_s(ref), _pcie_s(port)
    assert port_p == pytest.approx(ref_p, rel=1e-12)
    for t in ref["host_pages"]:
        _assert_pages_close(ref["host_pages"][t], port["host_pages"][t],
                            page_tol)
    for key in ref:
        if key != "host_pages":
            assert port[key] == ref[key], key


def run_both(tiny, scenario, **kw):
    """``scenario(side, clock, **kw) -> (engine, requests)`` on both sides;
    returns (reference snapshot, port snapshot, port engine)."""
    snaps, eng = [], None
    for name in ("ref", "port"):
        clock = {"t": 0.0}
        eng, reqs = scenario(side(tiny, name), clock, **kw)
        snaps.append(snapshot(eng, reqs))
    return snaps[0], snaps[1], eng


def prompts(seed: int, n: int, length: int = 8):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 100, length).astype(np.int32) for _ in range(n)]
