"""The port's disaggregated prefill/decode engine
(``repro_torch.serving.disagg``) against the reference's.

Twins of the nine tests of ``tests/test_disagg.py`` on the port (decode
tokens bit-equal to one co-located engine, pipelined or whole-group; the
degenerate request; seeded replay; device lending; the control-plane
satellites), then one seeded scenario run on both sides with the same
weights (the port's seeded init, given to the reference through
``bridge.to_numpy``): ``fingerprint()`` (outputs, flow sizes and times,
lending), ``metrics()["interconnect"]`` and ``["migrations"]``, and the
traced JSONL byte for byte. Also: the engine raises without CUDA unless
``torch_device="cpu"`` is given, and its default weights are the same in
every process (the reference salts them per process)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

import _torch_serving_parity as par
import repro.obs as jobs
import repro.serving as jserving
from repro.core.tenancy import TenantSpec as JSpec
from repro_torch import obs
from repro_torch.configs import smoke_config
from repro_torch.core.compute import ElasticMeshPartitioner, LoadSignal
from repro_torch.core.controller import (ResourcePlan, grid_search,
                                         lending_plan, measured_prefix_hit)
from repro_torch.core.interconnect import Topology, ring_allgather_flows
from repro_torch.core.simulator import GPU_DEVICES
from repro_torch.core.tenancy import TenantSpec
from repro_torch.models import transformer as tf
from repro_torch.serving import DisaggregatedEngine, ServingEngine

MAX_SEQ = 32
ROOT = Path(__file__).resolve().parents[1]
CPU = {"torch_device": "cpu"}


@pytest.fixture(scope="module")
def tiny():
    cfg = smoke_config("stablelm-1.6b").replace(num_layers=1,
                                                activation_dtype="float32")
    return cfg, tf.init_params(cfg, 7, "cpu")


def _prompts(seed=0, lens=(9, 5, 13, 7, 4)):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 50, size=L).tolist() for L in lens]


def _baseline_outputs(cfg, params, prompts, max_new=6):
    eng = ServingEngine(max_seq=MAX_SEQ, paged=True, page_size=4,
                        chunk_size=4, slots_ls=4, slots_be=4, **CPU)
    eng.add_tenant(TenantSpec("ls0", "LS"), cfg, params=params)
    reqs = [eng.submit("ls0", p, max_new=max_new) for p in prompts]
    eng.run_until_idle()
    return [[int(x) for x in r.output] for r in reqs]


def _disagg(cfg, params, *, pipeline=True, n_devices=2, n_prefill=1,
            seed=0, **kw):
    dis = DisaggregatedEngine(max_seq=MAX_SEQ, page_size=4, chunk_size=4,
                              n_devices=n_devices, n_prefill=n_prefill,
                              pipeline=pipeline, seed=seed, **CPU, **kw)
    dis.add_tenant(TenantSpec("ls0", "LS"), cfg, params=params)
    return dis


# ---------------------------------------------------------------------------
# twins of tests/test_disagg.py
# ---------------------------------------------------------------------------

def test_disagg_bit_equal_to_colocated(tiny):
    cfg, params = tiny
    prompts = _prompts()
    base = _baseline_outputs(cfg, params, prompts)
    dis = _disagg(cfg, params)
    for p in prompts:
        dis.submit("ls0", p, max_new=6)
    dis.run_until_idle(max_rounds=5000)
    assert dis.outputs("ls0") == base
    m = dis.metrics()
    assert m["interconnect"]["xfer_bytes"] > 0
    assert m["migrations"]["delivered"] == len(prompts)
    assert m["migrations"]["in_flight"] == 0


def test_pipelined_bit_equal_to_all_at_once(tiny):
    cfg, params = tiny
    prompts = _prompts(seed=3, lens=(12, 9, 16))
    runs = {}
    for pipeline in (True, False):
        dis = _disagg(cfg, params, pipeline=pipeline)
        for p in prompts:
            dis.submit("ls0", p, max_new=5)
        dis.run_until_idle(max_rounds=5000)
        runs[pipeline] = dis
    assert runs[True].outputs("ls0") == runs[False].outputs("ls0")
    assert runs[True].outputs("ls0") == _baseline_outputs(cfg, params,
                                                          prompts, 5)
    a, b = (runs[k].metrics()["interconnect"] for k in (True, False))
    assert a["xfer_bytes"] == b["xfer_bytes"]
    assert a["flows"] > b["flows"]


def test_degenerate_request_finishes_on_prefill_slice(tiny):
    cfg, params = tiny
    dis = _disagg(cfg, params)
    dis.submit("ls0", list(range(1, 8)), max_new=1)
    dis.run_until_idle(max_rounds=2000)
    [out] = dis.outputs("ls0")
    assert len(out) == 1
    m = dis.metrics()
    assert m["migrations"]["started"] == 0
    assert m["interconnect"]["xfer_bytes"] == 0
    drt = dis.decode.tenants["ls0"]
    assert len(drt.host) == 0


def test_seeded_replay_bit_identical(tiny):
    cfg, params = tiny
    prompts = _prompts(seed=11, lens=(10, 6, 14, 8))

    def run():
        dis = _disagg(cfg, params, n_devices=4, n_prefill=2, seed=5)
        for p in prompts:
            dis.submit("ls0", p, max_new=6)
        dis.run_until_idle(max_rounds=5000)
        return dis.fingerprint()

    assert run() == run()


@given(total=st.integers(2, 64), min_ls=st.integers(1, 8),
       queued=st.integers(0, 40), active=st.integers(0, 16),
       slots=st.integers(1, 16))
@settings(max_examples=60, deadline=None)
def test_rebalance_from_signal_invariants(total, min_ls, queued, active,
                                          slots):
    part = ElasticMeshPartitioner(total, min_ls=min_ls)
    sig = LoadSignal(ls_queued=queued, ls_active=active, ls_slots=slots)
    out = part.rebalance_from_signal(sig)
    assert out["LS"] + out["BE"] == total
    assert out["LS"] >= min(min_ls, total)
    assert out["BE"] >= 0
    assert out == part.rebalance(sig.ls_load)


def test_lending_reacts_to_prefill_drain(tiny):
    cfg, params = tiny
    dis = _disagg(cfg, params, n_devices=4, n_prefill=2, control_interval=2)
    for p in _prompts(seed=2, lens=(14, 12, 10, 13, 11, 9)):
        dis.submit("ls0", p, max_new=6)
    dis.run_until_idle(max_rounds=5000)
    log = dis.lending_log
    assert all(e["prefill_devices"] + e["decode_devices"] == 4 for e in log)
    assert all(e["prefill_devices"] >= 1 for e in log)
    assert log[0]["prefill_devices"] > log[-1]["prefill_devices"]
    assert log[-1]["prefill_devices"] == 1
    cons = dis.work_conservation()
    assert cons["rounds"] == dis.rounds


def test_plan_swap_quantum_pages_applied_and_restored(tiny):
    cfg, params = tiny
    eng = ServingEngine(max_seq=MAX_SEQ, paged=True, page_size=4,
                        swap=True, grow_pages=True, swap_quantum_pages=4,
                        **CPU)
    eng.add_tenant(TenantSpec("ls0", "LS"), cfg, params=params)
    throttled = ResourcePlan(sm_be=0.3, ch_be=0.5, thres_dram=0.5,
                             ls_channels=(0, 1), be_channels=(2, 3),
                             max_ls_inflation=1.2, swap_quantum_pages=1)
    eng.apply_plan(throttled)
    assert eng.swap_quantum_pages == 1
    eng.apply_plan(lending_plan(throttled, 8))
    assert eng.swap_quantum_pages == 4


def test_grid_search_prefix_hit_relaxes_be_pressure():
    dev = GPU_DEVICES["tesla-p40"]
    cfgs = [smoke_config("stablelm-1.6b")]
    cold = grid_search(dev, cfgs, cfgs, pairs_per_model=2,
                       prefix_hit=0.0, swap_quantum_pages=2)
    warm = grid_search(dev, cfgs, cfgs, pairs_per_model=2,
                       prefix_hit=0.9, swap_quantum_pages=2)
    assert cold.swap_quantum_pages == 2
    assert warm.swap_quantum_pages == 2
    assert warm.sm_be >= cold.sm_be
    assert lending_plan(warm, 8).swap_quantum_pages is None


def test_measured_prefix_hit_feedback(tiny):
    cfg, params = tiny
    eng = ServingEngine(max_seq=MAX_SEQ, paged=True, page_size=4,
                        chunk_size=4, prefix_cache=True, **CPU)
    eng.add_tenant(TenantSpec("ls0", "LS"), cfg, params=params)
    assert measured_prefix_hit(eng) == 0.0
    prompt = list(range(1, 17))
    for _ in range(3):
        eng.submit("ls0", prompt, max_new=2)
        eng.run_until_idle()
    hit = measured_prefix_hit(eng)
    assert 0.0 < hit <= 1.0


# ---------------------------------------------------------------------------
# the port against the reference, one seeded scenario
# ---------------------------------------------------------------------------

def _scenario(side: str, pipeline: bool):
    """Two LS tenants on a 4-device host star (2 prefill), a ring
    collective in the background, a degenerate request and one prompt at
    max_seq (both finish on the prefill slice), traced at "debug"."""
    jcfg, cfg, jp, tp = par.tiny_models()
    if side == "ref":
        Eng, Spec, tr, c, p, kw = (jserving.DisaggregatedEngine, JSpec,
                                   jobs.Tracer("debug"), jcfg, jp, {})
    else:
        Eng, Spec, tr, c, p, kw = (DisaggregatedEngine, TenantSpec,
                                   obs.Tracer("debug"), cfg, tp, CPU)
    devices = [f"dev{i}" for i in range(4)]
    bg = ring_allgather_flows(Topology.host_star(devices), devices, 4096,
                              rounds=2, fid0=0)
    dis = Eng(max_seq=MAX_SEQ, page_size=4, chunk_size=4, n_devices=4,
              n_prefill=2, pipeline=pipeline, seed=5, tracer=tr,
              control_interval=2, background_flows=bg, **kw)
    for name in ("ls0", "ls1"):
        dis.add_tenant(Spec(name, "LS", nice=10 if name == "ls0" else 1),
                       c, params=p)
    rng = np.random.default_rng(23)
    for i, L in enumerate((11, 6, 15, 9, 7, 13)):
        dis.submit(("ls0", "ls1")[i % 2], rng.integers(1, 60, L).tolist(),
                   max_new=5)
    dis.submit("ls0", rng.integers(1, 60, 8).tolist(), max_new=1)
    dis.submit("ls1", rng.integers(1, 60, MAX_SEQ).tolist(), max_new=3)
    dis.run_until_idle(max_rounds=5000)
    m = dis.metrics()
    return {"fingerprint": dis.fingerprint(),
            "interconnect": m["interconnect"],
            "migrations": m["migrations"],
            "lending": m["lending"],
            "work_conservation": m["work_conservation"],
            "tenants": {s: {t: {k: m[s][t].get(k) for k in
                                ("completed", "failed", "kv_pages")}
                            for t in ("ls0", "ls1")}
                        for s in ("prefill", "decode")}}, tr.jsonl()


@pytest.mark.parametrize("pipeline", [True, False])
def test_port_equals_reference(pipeline):
    ref, ref_jsonl = _scenario("ref", pipeline)
    port, port_jsonl = _scenario("port", pipeline)
    assert ref["migrations"]["delivered"] == 6
    assert ref["interconnect"]["flows"] > 8      # collectives + KV flows
    assert port == ref
    assert port_jsonl == ref_jsonl
    assert '"kind":"flow"' in port_jsonl and '"kind":"lending"' in port_jsonl


def test_engine_runs_on_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        assert DisaggregatedEngine().prefill.torch_device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            DisaggregatedEngine()
    dis = DisaggregatedEngine(**CPU)
    assert dis.prefill.torch_device.type == dis.decode.torch_device.type \
        == "cpu"


_WEIGHTS = """
import hashlib, json, numpy as np
import jax
from repro_torch import bridge
from repro_torch.configs import smoke_config
from repro_torch.core.tenancy import TenantSpec
from repro_torch.serving import DisaggregatedEngine
import repro.serving as jserving
from repro.configs import smoke_config as jsmoke
from repro.core.tenancy import TenantSpec as JSpec

def leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]

def digest(leaves):
    h = hashlib.sha256()
    for a in leaves:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()

cfg = smoke_config("stablelm-1.6b").replace(num_layers=1,
                                            activation_dtype="float32")
dis = DisaggregatedEngine(max_seq=16, torch_device="cpu")
prt, drt = dis.add_tenant(TenantSpec("ls0", "LS"), cfg)
shared = all(a is b for a, b in zip(leaves(prt.params),
                                    leaves(drt.params)))
port = digest(leaves(bridge.to_numpy(prt.params)))
jdis = jserving.DisaggregatedEngine(max_seq=16)
jrt, _ = jdis.add_tenant(JSpec("ls0", "LS"),
                         jsmoke("stablelm-1.6b").replace(
                             num_layers=1, activation_dtype="float32"))
ref = digest(np.asarray(a) for a in jax.tree.leaves(jrt.params))
print(json.dumps({"shared": shared, "port": port, "ref": ref}))
"""


def test_default_weights_equal_across_processes():
    """Two processes with different string-hash salts: the port's default
    weights (crc32 of the tenant's name) are the same and shared by both
    slices; the reference's (``hash(spec.name)``) differ, its salted-init
    fault."""
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WEIGHTS], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONHASHSEED=salt, JAX_PLATFORMS="cpu",
                 PYTHONPATH=str(ROOT / "src"))) for salt in ("1", "2")]
    outs = []
    for proc in procs:
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err
        outs.append(json.loads(out.strip().splitlines()[-1]))
    a, b = outs
    assert a["shared"] and b["shared"]
    assert a["port"] == b["port"]
    assert a["ref"] != b["ref"]
