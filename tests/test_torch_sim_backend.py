"""The port's simulator backend (``ServingEngine(backend="sim")``) against
the reference's.

Twins of the reference's sim-backend tests
(``test_engine_batching.py::test_sim_decode_phase_reflects_kv_write_mode``
and ``::test_sim_backend_same_request_stream``,
``test_scheduler.py::test_sim_models_chunked_prefill_phases``,
``test_kv_hierarchy.py::test_sim_charges_swap_bytes_to_owning_class``,
``::test_model_costs_swap_op`` and ``::test_engine_sim_swap_bytes``,
``test_faults.py::test_sim_bw_degrade_inflates_latency_deterministically``)
on the port, then seeded request streams whose ``metrics()``,
``sim_result`` and traced JSONL must equal the reference's exactly: both
sides are pure host code over verbatim copies of the simulator and the
cost model, so nothing is held to a tolerance."""
import json

import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.core.controller as jctl
import repro.core.simulator as jsim
import repro.obs as jobs
import repro.serving as jserving
from repro.core.tenancy import TenantSpec as JSpec
import repro_torch.configs as configs
import repro_torch.core.controller as ctl
import repro_torch.core.simulator as sim
import repro_torch.serving as serving
from repro_torch import obs
from repro_torch.configs import smoke_config
from repro_torch.core.compute import ComputePolicy
from repro_torch.core.costmodel import model_costs
from repro_torch.core.simulator import (GPU_DEVICES, GPUSimulator, Tenant,
                                        request_kernels)
from repro_torch.core.tenancy import TenantSpec
from repro_torch.serving import FaultEvent, FaultPlane, ServingEngine

MAX_SEQ = 24
CPU = {"torch_device": "cpu"}


@pytest.fixture(scope="module")
def tiny():
    cfg = smoke_config("stablelm-1.6b").replace(num_layers=1,
                                                activation_dtype="float32")
    return cfg


# ---------------------------------------------------------------------------
# twins of the reference's sim-backend tests
# ---------------------------------------------------------------------------

def test_sim_decode_phase_reflects_kv_write_mode(tiny):
    cfg = tiny

    def p99(paged):
        eng = ServingEngine(max_seq=MAX_SEQ, backend="sim",
                            device="rtx-a5500", paged=paged, **CPU)
        eng.add_tenant(TenantSpec("ls0", "LS", batch_size=1), cfg)
        for t in np.linspace(0.0, 0.5, 8):
            eng.submit("ls0", np.zeros(8, np.int32), max_new=16, at=float(t))
        eng.run_until_idle(horizon=5.0)
        return eng.metrics()["_class"]["LS"]["p99_ms"]

    assert p99(True) < p99(False)


def test_sim_backend_same_request_stream(tiny):
    cfg = tiny
    eng = ServingEngine(max_seq=MAX_SEQ, backend="sim", device="rtx-a5500",
                        policy="sgdrc", coloring=True, **CPU)
    eng.add_tenant(TenantSpec("ls0", "LS", batch_size=1), cfg, sim_seq=64)
    eng.add_tenant(TenantSpec("be0", "BE", batch_size=4), cfg,
                   closed_loop=True, sim_seq=128)
    for t in np.linspace(0.0, 1.0, 20):
        eng.submit("ls0", np.zeros(8, np.int32), max_new=4, at=float(t))
    done = eng.run_until_idle(horizon=2.0)
    assert done > 0
    m = eng.metrics()
    assert m["ls0"]["completed"] > 0
    assert m["be0"]["completed"] > 0
    assert m["_class"]["LS"]["p99_ms"] is not None
    assert eng.sim_result is not None
    assert eng.sim_result.be_throughput() > 0
    # no tensor: no weights, no cache, no arena
    assert all(rt.params is None and rt.cache is None
               for rt in eng.tenants.values())
    assert eng.arena is None


def test_sim_backend_needs_no_card(tiny):
    """The sim backend resolves no device: it builds and runs with the
    default ``torch_device`` on a host without CUDA, while the torch
    backend's default still asks for CUDA and raises without it."""
    eng = ServingEngine(max_seq=MAX_SEQ, backend="sim", device="rtx-a5500")
    assert eng.torch_device is None
    eng.add_tenant(TenantSpec("ls0", "LS", batch_size=1), tiny, sim_seq=64)
    eng.submit("ls0", np.zeros(8, np.int32), max_new=4, at=0.0)
    assert eng.run_until_idle(horizon=1.0) == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingEngine(max_seq=MAX_SEQ)


def test_sim_models_chunked_prefill_phases(tiny):
    cfg = tiny

    def run(chunk):
        eng = ServingEngine(max_seq=MAX_SEQ, backend="sim",
                            device="rtx-a5500", chunk_size=chunk, **CPU)
        eng.add_tenant(TenantSpec("ls0", "LS", batch_size=1), cfg)
        for t in np.linspace(0.0, 0.2, 4):
            eng.submit("ls0", np.zeros(32, np.int32), max_new=8, at=float(t))
        eng.run_until_idle(horizon=3.0)
        return eng.sim_result

    mono, chunked = run(None), run(8)
    tn_c = chunked.tenants[0]
    assert tn_c.prefill_kernels == 4
    assert tn_c.ttfts and tn_c.tbt_gaps
    assert np.isfinite(chunked.ls_ttft_p99())
    assert np.isfinite(chunked.ls_tbt_p99())
    mono_pre = sum(k.bytes
                   for k in mono.tenants[0].kernels
                   [:mono.tenants[0].prefill_kernels])
    chunk_pre = sum(k.bytes for k in tn_c.kernels[:tn_c.prefill_kernels])
    assert chunk_pre > mono_pre


def test_sim_charges_swap_bytes_to_owning_class(tiny):
    cfg = tiny
    dev = GPU_DEVICES["rtx-a5500"]
    swap_b = int(200e6)

    def run(be_swap):
        ls_pre = request_kernels(cfg, 1, 64, "prefill", dev)
        ls_dec = request_kernels(cfg, 1, 64, "decode", dev, kv_write="paged")
        be_k = request_kernels(cfg, 4, 64, "prefill", dev,
                               swap_bytes=be_swap)
        ls = Tenant("ls0", "LS", ls_pre + ls_dec * 4,
                    arrivals=list(np.arange(0.0, 0.2, 0.01)),
                    prefill_kernels=len(ls_pre))
        be = Tenant("be0", "BE", be_k, closed_loop=True)
        sim = GPUSimulator(dev, ComputePolicy(kind="sgdrc", sm_be=0.3),
                           coloring=True, ch_be=1 / 3)
        res = sim.run([ls, be], 0.25)
        return res.ls_tbt_p99(), be.completed

    tbt_off, be_off = run(0)
    tbt_on, be_on = run(swap_b)
    assert be_on < be_off
    assert tbt_on <= tbt_off * 1.05 + 1e-6, (tbt_on, tbt_off)


def test_model_costs_swap_op(tiny):
    cfg = tiny
    for kw in ({}, {"chunk": 8}):
        ops = model_costs(cfg, 1, 32, "prefill", swap_bytes=12345, **kw)
        tail = ops[-1]
        assert tail.name == "swap_pcie"
        assert tail.flops == 0.0 and tail.bytes == 12345.0
        assert not any(o.name == "swap_pcie" for o in
                       model_costs(cfg, 1, 32, "prefill", **kw))


def test_engine_sim_swap_bytes(tiny):
    cfg = tiny

    def lat(swap_bytes):
        eng = ServingEngine(backend="sim", max_seq=64, coloring=True,
                            ch_be=1 / 3, **CPU)
        eng.add_tenant(TenantSpec("be0", "BE"), cfg,
                       sim_swap_bytes=swap_bytes, max_kernels=4)
        r = eng.submit("be0", np.arange(32), max_new=8, at=0.0)
        eng.run_until_idle(horizon=5.0)
        return r.latency

    assert lat(int(500e6)) > lat(0)


def _sim_p99(cfg, faults=None):
    eng = ServingEngine(max_seq=MAX_SEQ, backend="sim", device="rtx-a5500",
                        faults=faults, **CPU)
    eng.add_tenant(TenantSpec("ls0", "LS", batch_size=1), cfg)
    for t in np.linspace(0.0, 0.5, 8):
        eng.submit("ls0", np.zeros(8, np.int32), max_new=8, at=float(t))
    eng.run_until_idle()
    return eng.metrics()["ls0"]["p99_ms"]


def test_sim_bw_degrade_inflates_latency_deterministically(tiny):
    cfg = tiny
    clean = _sim_p99(cfg)
    mk = lambda: FaultPlane([FaultEvent(0.0, "bw_degrade", duration=10.0,
                                        magnitude=0.25)])
    a, b = _sim_p99(cfg, mk()), _sim_p99(cfg, mk())
    assert a == b
    assert a > clean


# ---------------------------------------------------------------------------
# the port against the reference on seeded streams
# ---------------------------------------------------------------------------

def _stream(side: str, scenario: str):
    """One seeded stream on either side's sim engine: full qwen3-1.7b LS
    and gemma2-9b BE configs. "colored": chunked, tiled BE prefill, paged,
    colored, a static plan, a closed-loop BE tenant with swap bytes, a
    bw_degrade window. "tidal": whole-row KV, the prefix cache's suffix
    estimate over shared prompts, an OnlineController over a frontier with
    migration costing, submissions with and without ``at``."""
    ref = side == "ref"
    sv, cm, cf, Spec = ((jserving, jctl, jconfigs, JSpec) if ref else
                        (serving, ctl, configs, TenantSpec))
    tracer = (jobs if ref else obs).Tracer("debug")
    kw = {} if ref else dict(CPU)
    ls_cfg, be_cfg = cf.get_config("qwen3-1.7b"), cf.get_config("gemma2-9b")
    clock = {"t": 0.0}
    rng = np.random.default_rng(31)
    if scenario == "colored":
        kw.update(plan=cm.ResourcePlan(sm_be=0.3, ch_be=0.5, thres_dram=0.4,
                                       ls_channels=(), be_channels=(),
                                       max_ls_inflation=0.25),
                  chunk_size=64, preempt_tile=16, paged=True, coloring=True,
                  faults=sv.FaultPlane([sv.FaultEvent(
                      0.2, "bw_degrade", duration=0.3, magnitude=0.5)]))
    else:
        dev = (jsim if ref else sim).GPU_DEVICES["rtx-a5500"]
        frontier = cm.frontier_search(
            dev, [cf.smoke_config("qwen3-1.7b")],
            [cf.smoke_config("gemma2-9b")], load_grid=(0.5, 1.0),
            pairs_per_model=1, sm_grid=(0.2, 0.4), ch_grid=(0.5,),
            thres_grid=(0.4,))
        kw.update(prefix_cache=True, controller=cm.OnlineController(frontier),
                  control_dt=0.05, migration_bytes=1e6)
    eng = sv.ServingEngine(max_seq=256, backend="sim", device="rtx-a5500",
                           now_fn=lambda: clock["t"], tracer=tracer, **kw)
    eng.add_tenant(Spec("ls:q", "LS", nice=10_000), ls_cfg,
                   max_kernels=12)
    be_kw = ({"closed_loop": True, "sim_seq": 256,
              "sim_swap_bytes": int(64e6)} if scenario == "colored"
             else {})
    eng.add_tenant(Spec("be:g", "BE", nice=1, batch_size=4), be_cfg,
                   max_kernels=8, **be_kw)
    shared = rng.integers(0, 500, 48)
    reqs = []
    for i in range(10):
        toks = rng.integers(0, 500, 96)
        if scenario == "tidal":
            toks[:48] = shared
        at = 0.07 * i if scenario == "colored" or i % 2 else None
        clock["t"] = 0.07 * i + 0.01
        reqs.append(eng.submit("ls:q", toks, max_new=12, at=at))
        if scenario == "tidal" and i % 3 == 0:
            reqs.append(eng.submit("be:g", toks, max_new=6, at=at))
    n = eng.run_until_idle(horizon=2.5 if scenario == "colored" else None)
    res = eng.sim_result
    return {"n": n, "metrics": json.loads(json.dumps(eng.metrics())),
            "horizon": res.horizon,
            "tenants": [(tn.name, tn.completed, tn.latencies, tn.ttfts,
                         tn.tbt_gaps, tn.prefill_kernels,
                         [(k.flops, k.bytes) for k in tn.kernels])
                        for tn in res.tenants],
            "reqs": [(r.t_submit, r.t_done, r.failed) for r in reqs],
            "transitions": eng.transitions,
            "migrated_bytes": eng.migrated_bytes}, tracer.jsonl()


@pytest.mark.parametrize("scenario", ["colored", "tidal"])
def test_sim_stream_equals_reference(scenario):
    ref, ref_jsonl = _stream("ref", scenario)
    port, port_jsonl = _stream("port", scenario)
    assert ref["n"] > 0
    assert ref["metrics"]["_class"]["LS"]["completed"] > 0
    assert port == ref
    assert port_jsonl == ref_jsonl
