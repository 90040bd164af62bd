"""The port's SSM and hybrid families against the reference: the chunked
linear-attention scan, the RWKV6 and Mamba2 blocks, the ``zamba2-1.2b`` and
``rwkv6-7b`` smoke models (``forward``, ``decode_step``, ``prefill``, with
their caches), the serving engine's monolithic-prefill path for an LS
zamba2 + BE rwkv6 pair, and ``ops.ssd_scan``.

CPU: the same inputs, made from a numpy seed, and the same weights (through
``repro_torch.bridge``) go to the reference and to the port. Tolerance 1e-4
(atol and rtol) for layers and rwkv6, 2e-4 for the scan kernel's plain
version (the reference's kernel tolerance). zamba2's smoke stack amplifies
rounding: the reference itself moves its logits by 3e-4 when its embedding
is scaled by 1 + 1e-6 (14 layers, two shared-block invocations), so zamba2
model outputs compare at 2e-3, which a wrong layer, cache write or shared
invocation still misses by orders of magnitude.

The reference's scan clamps the cumulative log-decay of a chunk to +-20;
the port computes the exact recurrence. Where the clamp is inactive the two
agree; ``test_exact_where_reference_clamp_bites`` shows where they do not.

CUDA (marked ``cuda``, skipped without a card): the ``ssd_scan`` kernel
against its plain version (f32, bf16, f16; ragged T, chunks above 64,
strong and mixed decays) and its output bit-equal across ``chunk``. JAX
is imported lazily, so that the file also runs on a machine without it.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import smoke_config
from repro_torch.core.controller import ResourcePlan
from repro_torch.core.tenancy import TenantSpec
from repro_torch.kernels import ops, ref
from repro_torch.models import ssm, transformer as tf
from repro_torch.serving import Phase, ServingEngine

TOL = dict(rtol=1e-4, atol=1e-4)
SCAN_TOL = dict(rtol=2e-4, atol=2e-4)
HYBRID_TOL = dict(rtol=2e-3, atol=2e-3)
SMAX = 24
FAMILIES = ("zamba2-1.2b", "rwkv6-7b")


@pytest.fixture(scope="module")
def jx():
    """The reference modules (JAX on the CPU)."""
    jax = pytest.importorskip("jax")
    from repro.configs import smoke_config as jsmoke
    from repro.core.controller import ResourcePlan as JPlan
    from repro.core.tenancy import TenantSpec as JSpec
    from repro.kernels import ops as jops
    from repro.models import ssm as jssm
    from repro.models import transformer as jtf
    from repro.serving import ServingEngine as JEngine
    return SimpleNamespace(jax=jax, jnp=jax.numpy, jsmoke=jsmoke, jops=jops,
                           jssm=jssm, jtf=jtf, JEngine=JEngine, JPlan=JPlan,
                           JSpec=JSpec)


@pytest.fixture(scope="module")
def models(jx):
    """name -> (reference cfg, port cfg, reference params, port params)."""
    out = {}
    for i, name in enumerate(FAMILIES):
        jcfg = jx.jsmoke(name)
        jp = jx.jtf.init_params(jx.jax.random.key(i), jcfg)
        out[name] = (jcfg, smoke_config(name), jp, _params(jx, jp))
    return out


def _params(jx, jp):
    return bridge.params_from_numpy(jx.jax.tree.map(np.asarray, jp), "cpu")


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(bridge.to_numpy(got), np.asarray(want), **tol)


def _trees_close(jx, got, want, tol):
    """Every leaf of a port tree against the reference tree's."""
    want = jx.jax.tree.map(np.asarray, want)
    got = bridge.to_numpy(got)
    flat_w = jx.jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jx.jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_w) == len(flat_g)
    for path, w in flat_w:
        np.testing.assert_allclose(flat_g[path], w, **tol,
                                   err_msg=jx.jax.tree_util.keystr(path))


def _tol(name):
    return HYBRID_TOL if name.startswith("zamba2") else TOL


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------

def _scan_inputs(rng, B=2, T=64, H=2, K=8, P=16, decay=0.2):
    q, k, v = _rand(rng, (B, T, H, K)), _rand(rng, (B, T, H, K)), \
        _rand(rng, (B, T, H, P))
    log_w = -np.abs(_rand(rng, (B, T, H, K))) * decay
    return q, k, v, log_w


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("chunk", [4, 16, 64])
@pytest.mark.parametrize("inclusive", [True, False])
def test_chunked_linear_attn(jx, inclusive, chunk, with_state):
    """Both semantics (inclusive; exclusive + bonus), with and without an
    initial state, at decays whose chunk cumsums stay inside the
    reference's clamp (at most 64 * 0.2 * |N(0,1)|)."""
    rng = np.random.default_rng(10 + chunk + 100 * inclusive)
    args = _scan_inputs(rng)
    kw = {"inclusive": inclusive, "chunk": chunk}
    jkw, tkw = dict(kw), dict(kw)
    if not inclusive:
        u = _rand(rng, (2, 8), 0.5)
        jkw["bonus"], tkw["bonus"] = jx.jnp.asarray(u), torch.from_numpy(u)
    if with_state:
        s0 = _rand(rng, (2, 2, 8, 16))
        jkw["initial_state"] = jx.jnp.asarray(s0)
        tkw["initial_state"] = torch.from_numpy(s0)
    jy, js = jx.jssm.chunked_linear_attn(*map(jx.jnp.asarray, args), **jkw)
    ty, ts = ssm.chunked_linear_attn(*_t(*args), **tkw)
    _close(ty, jy)
    _close(ts, js)


def test_chunked_linear_attn_needs_whole_chunks():
    args = _t(*_scan_inputs(np.random.default_rng(0), T=12))
    with pytest.raises(AssertionError):
        ssm.chunked_linear_attn(*args, chunk=8)
    with pytest.raises(ValueError):
        ops.ssd_scan(*args, chunk=8)


def test_exact_where_reference_clamp_bites(jx):
    """At a per-token log-decay of -0.7 and chunk 64 a chunk's cumulative
    decay reaches -45: the reference's clamp at -20 replaces exp(s_j - s_i)
    by exp(-20 - s_i) for every query past token ~28 of a chunk. The port
    equals the exact recurrence (``ref_ssd_scan``), while the reference's
    ``chunked_linear_attn`` and Pallas ``ssd_scan`` miss it by O(10)."""
    rng = np.random.default_rng(42)
    B, T, H, K = 1, 128, 2, 16
    q, k, v = _rand(rng, (B, T, H, K)), _rand(rng, (B, T, H, K)), \
        _rand(rng, (B, T, H, K))
    log_w = np.full((B, T, H, K), -0.7, np.float32)
    exact = ref.ref_ssd_scan(*_t(q, k, v, log_w))
    port = ssm.chunked_linear_attn(*_t(q, k, v, log_w), chunk=64)[0]
    _close(port, exact, SCAN_TOL)
    _close(ops.ssd_scan(*_t(q, k, v, log_w), chunk=64), exact, SCAN_TOL)
    ja = [jx.jnp.asarray(a) for a in (q, k, v, log_w)]
    ref_chunked = np.asarray(jx.jssm.chunked_linear_attn(*ja, chunk=64)[0])
    ref_pallas = np.asarray(jx.jops.ssd_scan(*ja, chunk=64))
    for out in (ref_chunked, ref_pallas):
        assert np.abs(out - exact.numpy()).max() > 10.0
    # at chunk 8 the cumsum stays above -20: everyone agrees
    small = np.asarray(jx.jssm.chunked_linear_attn(*ja, chunk=8)[0])
    _close(exact, small, SCAN_TOL)


def test_linear_attn_step(jx):
    rng = np.random.default_rng(3)
    B, H, K, P = 2, 3, 8, 16
    for inclusive in (True, False):
        q, k, lw = _rand(rng, (B, H, K)), _rand(rng, (B, H, K)), \
            -np.abs(_rand(rng, (B, H, K)))
        v, s0 = _rand(rng, (B, H, P)), _rand(rng, (B, H, K, P))
        u = _rand(rng, (H, K))
        bonus = None if inclusive else u
        jy, js = jx.jssm.linear_attn_step(
            *map(jx.jnp.asarray, (q, k, v, lw, s0)), inclusive=inclusive,
            bonus=None if bonus is None else jx.jnp.asarray(bonus))
        ty, ts = ssm.linear_attn_step(
            *_t(q, k, v, lw, s0), inclusive=inclusive,
            bonus=None if bonus is None else torch.from_numpy(bonus))
        _close(ty, jy)
        _close(ts, js)


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

def _block_params(jx, init, name, seed):
    """A block's reference params (small random values in the zero-init
    mixes and norms, so every path carries signal) and the port's copy."""
    jcfg = jx.jsmoke(name)
    jp = init(jx.jax.random.key(seed), "blk", jcfg, jx.jnp.float32)
    rng = np.random.default_rng(seed)
    for leaf in ("tm_mix", "cm_mix", "ln_x", "out_norm", "a_log",
                 "dt_bias"):
        if leaf in jp:
            jp[leaf] = jx.jnp.asarray(_rand(rng, jp[leaf].shape, 0.3))
    return jcfg, smoke_config(name), jp, _params(jx, jp)


@pytest.mark.parametrize("carry", [False, True])
def test_rwkv_time_and_channel_mix(jx, carry):
    jcfg, cfg, jp, tp = _block_params(jx, jx.jssm.init_rwkv_block,
                                      "rwkv6-7b", 4)
    rng = np.random.default_rng(5)
    B, T, D = 2, 16, cfg.d_model
    K = cfg.ssm.head_dim
    x = _rand(rng, (B, T, D))
    extra = ((_rand(rng, (B, D // K, K, K)), _rand(rng, (B, 1, D)))
             if carry else (None, None))
    jy, js, jsh = jx.jssm.rwkv_time_mix(
        jp, jx.jnp.asarray(x), jcfg,
        *(None if a is None else jx.jnp.asarray(a) for a in extra))
    ty, ts, tsh = ssm.rwkv_time_mix(
        tp, torch.from_numpy(x), cfg,
        *(None if a is None else torch.from_numpy(a) for a in extra))
    for got, want in ((ty, jy), (ts, js), (tsh, jsh)):
        _close(got, want)
    last = extra[1]
    jc, jcs = jx.jssm.rwkv_channel_mix(
        jp, jx.jnp.asarray(x), jcfg,
        None if last is None else jx.jnp.asarray(last))
    tc, tcs = ssm.rwkv_channel_mix(
        tp, torch.from_numpy(x), cfg,
        None if last is None else torch.from_numpy(last))
    _close(tc, jc)
    _close(tcs, jcs)


@pytest.mark.parametrize("carry", [False, True])
def test_mamba2_block(jx, carry):
    jcfg, cfg, jp, tp = _block_params(jx, jx.jssm.init_mamba2_block,
                                      "zamba2-1.2b", 6)
    rng = np.random.default_rng(7)
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    B, T = 2, 16
    x = _rand(rng, (B, T, cfg.d_model))
    extra = ((_rand(rng, (B, d_in // s.head_dim, s.state_dim, s.head_dim)),
              _rand(rng, (B, s.conv_dim - 1, d_in + 2 * s.state_dim)))
             if carry else (None, None))
    jout = jx.jssm.mamba2_block(
        jp, jx.jnp.asarray(x), jcfg,
        *(None if a is None else jx.jnp.asarray(a) for a in extra))
    tout = ssm.mamba2_block(
        tp, torch.from_numpy(x), cfg,
        *(None if a is None else torch.from_numpy(a) for a in extra))
    for got, want in zip(tout, jout):
        _close(got, want)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

def test_supported_families():
    for name in FAMILIES + ("qwen3-1.7b", "gemma2-9b", "nemotron-4-15b"):
        tf.check_supported(smoke_config(name))
    for name in ("deepseek-v2-236b", "moonshot-v1-16b-a3b", "whisper-small",
                 "llama-3.2-vision-90b"):
        with pytest.raises(NotImplementedError):
            tf.check_supported(smoke_config(name))
    for name in FAMILIES:
        cfg = smoke_config(name)
        assert not tf.pageable(cfg) and not tf.chunkable(cfg)
        with pytest.raises(ValueError):
            tf.init_paged_cache(cfg, 8, 4, device="cpu")


@pytest.mark.parametrize("name", FAMILIES)
def test_params_and_caches_match_reference_structure(jx, models, name):
    """Port init and the reference's: the same tree, shapes and dtypes."""
    jcfg, cfg, jp, _ = models[name]
    mine = tf.init_params(cfg, 0, "cpu")
    shape = lambda t: jx.jax.tree.map(lambda a: (tuple(a.shape),
                                                 str(a.dtype)), t)
    assert shape(bridge.to_numpy(mine)) == shape(
        jx.jax.tree.map(np.asarray, jp))
    jc = jx.jtf.init_cache(jcfg, 3, SMAX)
    tc = tf.init_cache(cfg, 3, SMAX, device="cpu")
    assert shape(bridge.to_numpy(tc)) == shape(
        jx.jax.tree.map(np.asarray, jc))


@pytest.mark.parametrize("name", FAMILIES)
def test_forward_matches_reference(jx, models, name):
    jcfg, cfg, jp, tp = models[name]
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 16))
    jl, _ = jx.jtf.forward(jp, jcfg,
                           {"tokens": jx.jnp.asarray(toks, jx.jnp.int32)})
    tl, aux = tf.forward(tp, cfg, {"tokens": torch.from_numpy(toks)})
    assert aux == {}
    _close(tl, jl, _tol(name))


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("name", FAMILIES)
def test_decode_step_matches_reference(jx, models, name, use_flash):
    """One decode step from a random cache at per-row positions, one row at
    the sentinel (its attention write drops; its SSM state advances, as in
    the reference): logits and every cache leaf."""
    jcfg, cfg, jp, tp = models[name]
    rng = np.random.default_rng(9)
    jcache = jx.jax.tree.map(
        lambda a: jx.jnp.asarray(_rand(rng, a.shape, 0.5), a.dtype),
        jx.jtf.init_cache(jcfg, 3, SMAX))
    tcache = bridge.cache_from_numpy(jx.jax.tree.map(np.asarray, jcache),
                                     "cpu")
    toks = rng.integers(0, cfg.vocab_size, (3, 1)).astype(np.int32)
    pos = np.asarray([5, SMAX, 17], np.int32)
    jl, jcache = jx.jtf.decode_step(jp, jcfg, jx.jnp.asarray(toks), jcache,
                                    jx.jnp.asarray(pos), use_flash=use_flash)
    tl, tcache = tf.decode_step(tp, cfg, torch.from_numpy(toks), tcache,
                                torch.from_numpy(pos), use_flash=use_flash)
    _close(tl, jl, _tol(name))
    _trees_close(jx, tcache, jcache, _tol(name))


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_matches_reference(jx, models, name):
    jcfg, cfg, jp, tp = models[name]
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size, (2, 12))
    jl, jcache = jx.jtf.prefill(
        jp, jcfg, {"tokens": jx.jnp.asarray(toks, jx.jnp.int32)}, SMAX)
    tl, tcache = tf.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)},
                            SMAX)
    _close(tl, jl, _tol(name))
    _trees_close(jx, tcache, jcache, _tol(name))
    # decode after prefill: the carried SSM state must have advanced
    nxt = torch.from_numpy(toks[:, :1])
    tl2, _ = tf.decode_step(tp, cfg, nxt, tcache, torch.tensor(12))
    jl2, _ = jx.jtf.decode_step(jp, jcfg, jx.jnp.asarray(toks[:, :1],
                                                         jx.jnp.int32),
                                jcache, jx.jnp.asarray(12, jx.jnp.int32))
    _close(tl2, jl2, _tol(name))


def test_zamba2_forward_at_chunk_64_equals_prefill(jx, models):
    """At zamba2's published chunk of 64 (2 x 64 tokens) the port's
    chunked ``forward`` equals the reference's token-by-token ``prefill``;
    the reference's own ``forward`` does not (its clamped scan)."""
    jcfg, cfg, jp, tp = models["zamba2-1.2b"]
    jcfg, cfg = (c.replace(ssm=dataclasses.replace(c.ssm, chunk=64))
                 for c in (jcfg, cfg))
    toks = np.random.default_rng(12).integers(0, cfg.vocab_size, (2, 64))
    jt = jx.jnp.asarray(toks, jx.jnp.int32)
    jl, _ = jx.jtf.prefill(jp, jcfg, {"tokens": jt}, 64)
    tl, _ = tf.forward(tp, cfg, {"tokens": torch.from_numpy(toks)},
                       last_only=True)
    _close(tl, jl, HYBRID_TOL)
    jf, _ = jx.jtf.forward(jp, jcfg, {"tokens": jt}, last_only=True)
    want = np.asarray(jl)
    rel = np.linalg.norm(np.asarray(jf) - want) / np.linalg.norm(want)
    assert rel > 0.1


# ---------------------------------------------------------------------------
# the engine: monolithic prefill, dense caches
# ---------------------------------------------------------------------------

def _ls_be_run(jx, models, side, use_flash):
    """LS zamba2 + BE rwkv6 under sm_be=0.3; BE arrives first, so quanta
    are contended. Two prompt lengths per class, so one admission batch
    runs two prefill groups."""
    zj, zc, zjp, ztp = models["zamba2-1.2b"]
    rj, rc, rjp, rtp = models["rwkv6-7b"]
    kw = dict(max_seq=48, slots_ls=3, slots_be=3, use_flash=use_flash)
    if side == "ref":
        eng = jx.JEngine(plan=_plan(jx.JPlan), **kw)
        eng.add_tenant(jx.JSpec("ls", "LS"), zj, params=zjp)
        eng.add_tenant(jx.JSpec("be", "BE"), rj, params=rjp)
    else:
        eng = ServingEngine(plan=_plan(ResourcePlan), torch_device="cpu",
                            **kw)
        eng.add_tenant(TenantSpec("ls", "LS"), zc, params=ztp)
        eng.add_tenant(TenantSpec("be", "BE"), rc, params=rtp)
    rng = np.random.default_rng(13)
    reqs = [eng.submit("be", rng.integers(0, 100, L), max_new=4)
            for L in (16, 16, 8)]
    reqs += [eng.submit("ls", rng.integers(0, 100, L), max_new=5)
             for L in (8, 16, 8, 16)]
    eng.run_until_idle()
    return [r.output for r in reqs], list(eng.events), eng


def _plan(cls):
    return cls(sm_be=0.3, ch_be=1 / 3, thres_dram=0.4, ls_channels=(),
               be_channels=(), max_ls_inflation=0.25)


@pytest.mark.parametrize("use_flash", [False, True])
def test_engine_matches_reference(jx, models, use_flash):
    want_tokens, want_events, _ = _ls_be_run(jx, models, "ref", use_flash)
    tokens, events, eng = _ls_be_run(jx, models, "port", use_flash)
    assert tokens == want_tokens
    assert events == want_events
    assert {pri for _, _, pri in events} == {"LS", "BE"}
    for rt in eng.tenants.values():
        assert rt.chunk_fn is None
        assert all(r.phase is Phase.FINISHED for r in rt.done)
        assert rt.prefill_computed == rt.prefill_tokens


def test_engine_counts_flash_decodes(monkeypatch):
    """With use_flash every zamba2 decode call runs the decode kernel once
    per shared-block invocation (the CPU path counts no launch, so this
    counts the entry point's calls)."""
    cfg = smoke_config("zamba2-1.2b")
    calls = []
    orig = ops.decode_attention

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    monkeypatch.setattr(ops, "decode_attention", counted)
    eng = ServingEngine(max_seq=32, slots_ls=2, use_flash=True,
                        torch_device="cpu")
    eng.add_tenant(TenantSpec("ls", "LS"), cfg, seed=3)
    for L in (5, 9):
        eng.submit("ls", np.arange(L) % 50, max_new=3)
    eng.run_until_idle()
    decodes = sum(1 for q in eng.quantum_log if q.decode_tokens)
    assert decodes > 0
    assert len(calls) == tf.n_shared_invocations(cfg) * decodes


def test_paged_engine_refuses_ssm():
    eng = ServingEngine(max_seq=32, paged=True, torch_device="cpu")
    with pytest.raises(AssertionError):
        eng.add_tenant(TenantSpec("be", "BE"), smoke_config("rwkv6-7b"),
                       seed=0)


# ---------------------------------------------------------------------------
# ops.ssd_scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,T,H,K,P,chunk,decay", [
    (1, 128, 2, 16, 32, 32, 0.2), (2, 64, 4, 8, 8, 16, 0.2),
    (1, 256, 1, 64, 64, 64, 0.2), (1, 32, 1, 8, 8, 8, 0.0),
])
def test_ssd_scan_matches_pallas(jx, B, T, H, K, P, chunk, decay):
    """The CPU path of ``ops.ssd_scan`` against the Pallas kernel (in
    interpret mode) at the shapes of ``tests/test_kernels.py`` and at zero
    decay, where the reference's clamp is inactive."""
    args = _scan_inputs(np.random.default_rng(T + K), B, T, H, K, P, decay)
    want = jx.jops.ssd_scan(*map(jx.jnp.asarray, args), chunk=chunk)
    ops.reset_launch_counts()
    got = ops.ssd_scan(*_t(*args), chunk=chunk)
    assert ops.launch_counts()["ssd_scan"] == 0
    _close(got, want, SCAN_TOL)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (rtol, atol x max(1, max |want|)) of the kernel against ref_ssd_scan: f32
# sums in other orders; a 16-bit output adds one rounding (2^-8 of the value
# in bf16, 2^-11 in f16) on each side
KERNEL_TOL = {"float32": (2e-4, 2e-4), "bfloat16": (2 ** -7, 2e-4),
              "float16": (2 ** -10, 2e-4)}


def _kernel_inputs(dev, B, T, H, K, P, dtype, seed):
    """q, k as stride-0 broadcasts over the heads and f32 log_w beside
    16-bit q, k, v, as mamba2 passes them; log_w still to be set."""
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)
    q = torch.randn(B, T, 1, K, generator=g, device=dev).to(dt) \
        .expand(B, T, H, K)
    k = torch.randn(B, T, 1, K, generator=g, device=dev).to(dt) \
        .expand(B, T, H, K)
    v = torch.randn(B, T, H, P, generator=g, device=dev).to(dt)
    return q, k, v, g


def _kernel_close(got, want, dtype):
    rtol, atol = KERNEL_TOL[dtype]
    scale = max(1.0, want.float().abs().max().item())
    d = (got.float() - want.float()).abs()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool(torch.isfinite(got.float()).all())
    assert bool((d <= rtol * want.float().abs() + atol * scale).all()), \
        d.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("B,T,H,K,P,chunk,decay", [
    (1, 128, 2, 16, 32, 32, 0.2), (2, 64, 4, 8, 8, 16, 0.2),
    (1, 256, 1, 64, 64, 64, 0.7), (1, 96, 3, 5, 70, 24, 0.5),
    (2, 40, 2, 32, 32, 40, 0.0), (1, 56, 2, 16, 16, 8, 0.5),
    (1, 256, 2, 64, 64, 128, 0.2), (1, 64, 2, 100, 48, 64, 0.3),
])
def test_ssd_scan_kernel_matches_plain(cuda, B, T, H, K, P, chunk, decay,
                                       dtype):
    """The kernel against ``ref_ssd_scan`` on the card, at the reference
    tests' shapes, a decay where the Pallas clamp would bite, ragged
    widths (K 5, P 70 over two column tiles, chunk 24), zero decay, T not
    a multiple of the kernel's 16-token sub-chunk (T 40, T 56 at chunk
    8), a chunk above 64 and K above 64; f32 log_w beside 16-bit q, k, v,
    as mamba2 passes it; q and k as stride-0 broadcasts over the heads, as
    mamba2 passes them."""
    q, k, v, g = _kernel_inputs(cuda, B, T, H, K, P, dtype, T + P)
    log_w = -decay * torch.randn(B, T, H, K, generator=g,
                                 device=cuda).abs()
    ops.reset_launch_counts()
    got = ops.ssd_scan(q, k, v, log_w, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssd_scan"] == 1
    _kernel_close(got, ref.ref_ssd_scan(q, k, v, log_w), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mixed", [False, True])
def test_ssd_scan_kernel_strong_decay(cuda, mixed, dtype):
    """A log-decay of -3 a token (-48 over a 16-token sub-chunk, -192 over
    a chunk of 64), where a product of decay factors underflows; mixed:
    half the channels at -3, the other half at 0, so undecayed sums of
    the whole sequence sit beside terms that vanish."""
    B, T, H, K, P = 2, 192, 2, 64, 64
    q, k, v, _ = _kernel_inputs(cuda, B, T, H, K, P, dtype, 7)
    log_w = torch.full((B, T, H, K), -3.0, device=cuda)
    if mixed:
        log_w[..., ::2] = 0.0
    got = ops.ssd_scan(q, k, v, log_w, chunk=64)
    torch.cuda.synchronize()
    _kernel_close(got, ref.ref_ssd_scan(q, k, v, log_w), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_kernel_bits_equal_across_chunk(cuda, dtype):
    """The kernel computes the exact recurrence on its own 16-token tiling,
    so the caller's chunk changes no bit of the output."""
    B, T, H, K, P = 1, 128, 4, 64, 64
    q, k, v, g = _kernel_inputs(cuda, B, T, H, K, P, dtype, 11)
    log_w = -0.5 * torch.randn(B, T, H, K, generator=g, device=cuda).abs()
    outs = [ops.ssd_scan(q, k, v, log_w, chunk=c) for c in (8, 16, 64)]
    torch.cuda.synchronize()
    for out in outs[1:]:
        assert torch.equal(out, outs[0])
