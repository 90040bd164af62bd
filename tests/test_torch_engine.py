"""The port's serving engine against the reference engine on the same weights.

Per-request greedy tokens over {dense, paged, paged+flash} x chunk_size in
{None, 2, 3, 8} (the grid of ``tests/test_scheduler.py``); an LS+BE run
under ``ResourcePlan(sm_be=0.3)`` whose tokens and quantum order
(``eng.events``) equal the reference's; a ``preempt_tile=2`` run with
forced tile-boundary preemption. The reference's tokens are chunking-
invariant (``tests/test_scheduler.py``), so one reference run per variant
is the oracle for every chunk size. One LS token stream each for the
``gemma2-9b`` (softcaps, local window: the torch-op attention core) and
``nemotron-4-15b`` (``sq_relu``) smoke configs, paged and chunked. Plus the
import guard: the port never imports JAX or the reference package.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.core.controller import ResourcePlan as JPlan
from repro.core.tenancy import TenantSpec as JSpec
from repro.models import transformer as jtf
from repro.serving import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import smoke_config
from repro_torch.core.controller import ResourcePlan
from repro_torch.core.tenancy import TenantSpec
from repro_torch.models import transformer as tf
from repro_torch.serving import Phase, ServingEngine

MAX_SEQ = 24
ROOT = Path(__file__).resolve().parents[1]
VARIANTS = {"dense": {}, "paged": {"paged": True, "page_size": 4},
            "paged+flash": {"paged": True, "page_size": 4,
                            "use_flash": True}}


@pytest.fixture(scope="module")
def tiny():
    """1-layer f32 stablelm: (reference cfg, port cfg, reference params,
    port params) — the same weights on both sides."""
    name = "stablelm-1.6b"
    jcfg = jsmoke(name).replace(num_layers=1, activation_dtype="float32")
    cfg = smoke_config(name).replace(num_layers=1,
                                     activation_dtype="float32")
    jp = jtf.init_params(jax.random.key(7), jcfg)
    return jcfg, cfg, jp, bridge.params_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu")


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 100, L) for L in lens]


def _serve_ref(jcfg, jp, prompts, max_new=5, **kw):
    eng = JEngine(max_seq=MAX_SEQ, slots_ls=max(len(prompts), 2), **kw)
    eng.add_tenant(JSpec("ls0", "LS"), jcfg, params=jp)
    reqs = [eng.submit("ls0", p, max_new=max_new) for p in prompts]
    eng.run_until_idle()
    return [r.output for r in reqs]


def _serve(cfg, tp, prompts, max_new=5, **kw):
    eng = ServingEngine(max_seq=MAX_SEQ, slots_ls=max(len(prompts), 2),
                        torch_device="cpu", **kw)
    eng.add_tenant(TenantSpec("ls0", "LS"), cfg, params=tp)
    reqs = [eng.submit("ls0", p, max_new=max_new) for p in prompts]
    eng.run_until_idle()
    assert all(r.phase is Phase.FINISHED for r in reqs)
    return [r.output for r in reqs]


@pytest.fixture(scope="module")
def ref_tokens(tiny):
    """Reference tokens per variant (monolithic prefill), computed once."""
    jcfg, _, jp, _ = tiny
    cache = {}

    def get(variant):
        if variant not in cache:
            cache[variant] = _serve_ref(jcfg, jp, _prompts(3, (4, 9, 6, 9)),
                                        **VARIANTS[variant])
        return cache[variant]
    return get


@pytest.mark.parametrize("chunk", [None, 2, 3, 8])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_tokens_match_reference(tiny, ref_tokens, variant, chunk):
    _, cfg, _, tp = tiny
    out = _serve(cfg, tp, _prompts(3, (4, 9, 6, 9)), chunk_size=chunk,
                 **VARIANTS[variant])
    assert out == ref_tokens(variant)
    assert all(len(o) == 5 for o in out)


def _ls_be(engine_cls, spec_cls, plan, cfg, params, seed, **kw):
    """LS and BE tenants on the same weights under a plan; BE prompts
    arrive first so every quantum is contended."""
    rng = np.random.default_rng(seed)
    be = [rng.integers(0, 100, int(rng.integers(8, 16))) for _ in range(3)]
    ls = [rng.integers(0, 100, int(rng.integers(3, 7))) for _ in range(3)]
    eng = engine_cls(max_seq=MAX_SEQ, slots_ls=2, slots_be=2, plan=plan,
                     **kw)
    eng.add_tenant(spec_cls("ls0", "LS"), cfg, params=params)
    eng.add_tenant(spec_cls("be0", "BE"), cfg, params=params)
    return eng, be, ls


def _plan(cls):
    return cls(sm_be=0.3, ch_be=1 / 3, thres_dram=0.4, ls_channels=(),
               be_channels=(), max_ls_inflation=0.25)


def test_ls_be_quantum_order_matches_reference(tiny):
    """sm_be=0.3 gives BE 3 of every 10 contended quanta: on the paged +
    flash path the port picks the same tenant at every step and emits the
    same tokens."""
    jcfg, cfg, jp, tp = tiny
    kw = VARIANTS["paged+flash"]
    outs, events = [], []
    for side in ("ref", "port"):
        if side == "ref":
            eng, be, ls = _ls_be(JEngine, JSpec, _plan(JPlan), jcfg, jp, 11,
                                 chunk_size=4, **kw)
        else:
            eng, be, ls = _ls_be(ServingEngine, TenantSpec,
                                 _plan(ResourcePlan), cfg, tp, 11,
                                 chunk_size=4, torch_device="cpu", **kw)
        reqs = [eng.submit("be0", p, max_new=4) for p in be]
        reqs += [eng.submit("ls0", p, max_new=4) for p in ls]
        eng.run_until_idle()
        outs.append([r.output for r in reqs])
        events.append(list(eng.events))
    assert outs[0] == outs[1]
    assert events[0] == events[1]
    assert {pri for _, _, pri in events[1]} == {"LS", "BE"}


def test_preempt_tile_matches_reference(tiny):
    """preempt_tile=2 with preemption forced at every tile boundary: tokens
    and the abort count equal the reference's."""
    jcfg, cfg, jp, tp = tiny
    outs, aborts = [], []
    for side in ("ref", "port"):
        if side == "ref":
            eng, be, ls = _ls_be(JEngine, JSpec, None, jcfg, jp, 5,
                                 chunk_size=6, preempt_tile=2)
        else:
            eng, be, ls = _ls_be(ServingEngine, TenantSpec, None, cfg, tp, 5,
                                 chunk_size=6, preempt_tile=2,
                                 torch_device="cpu")
        eng.preempt_hook = lambda: True
        reqs = [eng.submit("be0", p, max_new=2) for p in be]
        reqs += [eng.submit("ls0", p, max_new=3) for p in ls[:2]]
        eng.run_until_idle()
        outs.append({r.rid: list(r.output) for r in reqs})
        aborts.append(eng.preempt_aborts)
    assert outs[0] == outs[1]
    assert aborts[0] == aborts[1] > 0


@pytest.mark.parametrize("name", ["gemma2-9b", "nemotron-4-15b"])
def test_family_tokens_match_reference(name):
    """One LS stream on the full smoke config (f32; gemma2: four layers,
    window 16 reached by the longer prompts), paged with chunk 5 and
    ``use_flash`` (which gemma2's softcapped layers decline). Weights from
    the port's seeded init, so both sides and every run see the same
    ones (the reference's own init is salted per process, see
    ``tests/test_torch_models.py``)."""
    cfg, jcfg = smoke_config(name), jsmoke(name)
    tp = tf.init_params(cfg, 3, "cpu")
    jp = jax.tree.map(jnp.asarray, bridge.to_numpy(tp))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, L) for L in (7, 19, 12)]
    kw = dict(max_seq=32, slots_ls=3, paged=True, page_size=4,
              use_flash=True, chunk_size=5)
    outs = []
    for Eng, Spec, c, p, extra in ((JEngine, JSpec, jcfg, jp, {}),
                                   (ServingEngine, TenantSpec, cfg, tp,
                                    {"torch_device": "cpu"})):
        eng = Eng(**kw, **extra)
        eng.add_tenant(Spec("ls0", "LS"), c, params=p)
        reqs = [eng.submit("ls0", q, max_new=6) for q in prompts]
        eng.run_until_idle()
        outs.append([[int(t) for t in r.output] for r in reqs])
    assert outs[0] == outs[1]
    assert all(len(o) == 6 for o in outs[1])


def test_metrics_shape(tiny):
    _, cfg, _, tp = tiny
    eng = ServingEngine(max_seq=MAX_SEQ, slots_ls=2, paged=True, page_size=4,
                        chunk_size=3, torch_device="cpu")
    eng.add_tenant(TenantSpec("ls0", "LS"), cfg, params=tp)
    for p in _prompts(1, (5, 7)):
        eng.submit("ls0", p, max_new=3)
    eng.run_until_idle()
    m = eng.metrics()
    ls = m["_class"]["LS"]
    assert ls["completed"] == 2 and ls["tokens_per_s"] > 0
    assert ls["ttft"]["p50_ms"] is not None and ls["tbt"]["p99_ms"] >= 0
    assert m["ls0"]["kv_pages"]["in_use"] == 0


# ---------------------------------------------------------------------------
# import guard and device policy
# ---------------------------------------------------------------------------

_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)


def test_port_never_imports_jax_or_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    examples = sorted((ROOT / "examples").glob("*_torch.py"))
    assert len(examples) == 4
    files += examples
    assert len(files) > 20
    bad = [str(f) for f in files if _FORBIDDEN.search(f.read_text())]
    assert bad == []
    code = ("import sys; import repro_torch, repro_torch.serving.engine, "
            "repro_torch.serving.disagg, repro_torch.launch.serve, "
            "repro_torch.launch.train, repro_torch.train, "
            "repro_torch.core.coloring, "
            "repro_torch.kernels.ops, repro_torch.bridge; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'repro' "
            "or m.startswith('repro.')]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ,
                                   PYTHONPATH=str(ROOT / "src")),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_engine_runs_on_cuda_unless_asked_for_cpu():
    """No silent CPU fallback: the default device is CUDA, and asking for it
    on a host without CUDA raises."""
    if torch.cuda.is_available():
        assert ServingEngine().torch_device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            ServingEngine()
    assert ServingEngine(torch_device="cpu").torch_device.type == "cpu"


@pytest.mark.parametrize("opt", ["prefix_cache", "grow_pages", "swap",
                                 "faults"])
def test_unported_options_raise(opt):
    """The KV hierarchy and the fault plane are ported: each option builds
    a paged engine, and the hierarchy's options raise ValueError without
    ``paged=True`` on the torch backend, as the reference's do on its real
    backend. The simulator backend is ported and takes each of them (it
    models the hierarchy and needs no page pool)."""
    from repro_torch.serving import FaultPlane
    value = FaultPlane([]) if opt == "faults" else True
    eng = ServingEngine(torch_device="cpu", paged=True, **{opt: value})
    assert getattr(eng, opt) is value
    if opt != "faults":
        with pytest.raises(ValueError, match="paged=True"):
            ServingEngine(torch_device="cpu", **{opt: value})
    for paged in (True, False):
        sim = ServingEngine(torch_device="cpu", backend="sim", paged=paged,
                            **{opt: value})
        assert sim.backend_name == "sim" and getattr(sim, opt) is value


def test_unknown_or_unported_backend_raises():
    """The simulator backend is ported; "jax" is the reference's backend
    name and an unknown one here."""
    assert ServingEngine(torch_device="cpu",
                         backend="sim").backend_name == "sim"
    with pytest.raises(ValueError):
        ServingEngine(torch_device="cpu", backend="jax")
