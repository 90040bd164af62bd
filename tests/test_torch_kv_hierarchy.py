"""The port's KV memory hierarchy against the reference: twins of
``tests/test_kv_hierarchy.py`` (page growth, the host swap tier over the
PCIe CFS, the quantized cold tier) and of ``tests/test_paged_kv.py``'s
``write_prefill`` check.

The host pool's page format is the reference's: the same quantized bytes
and scales in int8 mode, and in fp16 mode the pool's own bits — for a bf16
pool its raw 16-bit patterns, whose CRC32 equals the reference's over its
bf16 host array. Every engine test runs the port's engine and the
reference engine on one virtual clock with the same weights
(``_torch_serving_parity``) and holds them equal in tokens, quantum order,
the quantum log's swap pages, the ``swap`` and ``prefix_cache`` metrics
(``pcie_s`` at rel 1e-12), and each host pool's keys, sizes and CRCs,
beside the reference test's own checks on the port. The sim-backend tests
of the reference file wait for the port's simulator backend.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _hypothesis_compat import given, settings, st  # noqa: E402
import _torch_serving_parity as par  # noqa: E402

import repro.core.pcie as jpcie  # noqa: E402
import repro.serving as jserving  # noqa: E402
from repro.serving.kv_cache import PagedKVCache as JKV  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import pcie  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serving import (HostSwapPool, dequantize_page,  # noqa: E402
                                 model_bytes, page_swap_requests,
                                 quantize_page, swap_requests)
from repro_torch.serving.kv_cache import PagedKVCache  # noqa: E402

MAX_SEQ = 32


@pytest.fixture(scope="module")
def tiny():
    return par.tiny_models()


# ---------------------------------------------------------------------------
# cold-tier quantization primitives and the host pool's page format
# ---------------------------------------------------------------------------

@given(seed=st.integers(0, 10_000))
@settings(max_examples=5, deadline=None)
def test_quantize_roundtrip_bound(seed):
    """Per-page abs-max int8: the reference's bytes and scale, roundtrip
    error bounded by scale/2 per element, all-zero pages exact."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 3, size=(2, 4, 8)).astype(np.float32)
    q, scale = quantize_page(x)
    jq, jscale = jserving.quantize_page(x)
    assert q.dtype == np.int8 and scale == jscale
    np.testing.assert_array_equal(q, jq)
    err = np.abs(dequantize_page(q, scale) - x)
    assert err.max() <= scale / 2 + 1e-6
    qz, sz = quantize_page(np.zeros((3, 3), np.float32))
    assert sz == 0.0 and not qz.any()


def _pool_arr(seed=0):
    return np.random.default_rng(seed).normal(size=(1, 4, 2, 4, 8))


def _both_pools(arr, dtype=torch.float32):
    """The same page pool as port tensors and reference jax arrays."""
    t = torch.from_numpy(np.asarray(arr, np.float32)).to(dtype)
    j = jnp.asarray(bridge.to_numpy({"k": t})["k"],
                    jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    return {"layers": {"k": t}}, {"layers": {"k": j}}


def test_host_pool_fp16_roundtrip_exact():
    """fp16 (native-dtype) cold mode: a put/get is bit-identical and
    writes in place, both directions are logged as PCIe copies, and the
    stored page and its CRC are the reference's."""
    pools, jpools = _both_pools(_pool_arr(0))
    leaf = pools["layers"]["k"]
    before = leaf[:, 2].clone()
    host, jhost = HostSwapPool("fp16"), jserving.HostSwapPool("fp16")
    assert host.put(pools, "pg", 2) == jhost.put(jpools, "pg", 2)
    assert host.pages["pg"].crc == jhost.pages["pg"].crc
    leaf[:, 2] = 0.0                   # clobber the device page
    out, _ = host.get(pools, "pg", 2)
    assert out is pools and out["layers"]["k"] is leaf
    assert torch.equal(leaf[:, 2], before)
    assert "pg" not in host
    assert [c.direction for c in host.copies] == ["d2h", "h2d"]
    assert host.pcie_seconds() > 0
    jhost.get(jpools, "pg", 2)
    assert host.stats() == jhost.stats()


def test_host_pool_int8_bounded():
    """int8 cold mode: the faulted page is within the per-leaf quantization
    bound of the original at ~4x fewer host bytes than fp32, and equals the
    reference's dequantized page."""
    pools, jpools = _both_pools(_pool_arr(1) * 2)
    orig = pools["layers"]["k"][:, 1].clone()
    host, jhost = HostSwapPool("int8"), jserving.HostSwapPool("int8")
    nbytes = host.put(pools, "pg", 1)
    assert nbytes == jhost.put(jpools, "pg", 1)
    assert nbytes * 4 <= orig.numel() * 4 + 16
    assert host.pages["pg"].scales == jhost.pages["pg"].scales
    pools, _ = host.get(pools, "pg", 1)
    jpools, _ = jhost.get(jpools, "pg", 1)
    back = pools["layers"]["k"][:, 1]
    bound = float(orig.abs().max()) / 127.0 / 2 + 1e-6
    assert float((back - orig).abs().max()) <= bound
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jpools["layers"]["k"][:, 1]))


def test_host_pool_bf16_fp16_mode_bit_exact():
    """A bf16 pool in fp16 mode (numpy has no bfloat16): the page is kept
    as its raw 16-bit patterns, so the round trip is bit-exact and its
    CRC32 equals the reference's over the same page bits; int8 mode
    quantizes the page's f32 values to the reference's bytes."""
    pools, jpools = _both_pools(_pool_arr(2) * 3, torch.bfloat16)
    leaf = pools["layers"]["k"]
    before = leaf.clone()
    for mode in ("fp16", "int8"):
        host, jhost = HostSwapPool(mode), jserving.HostSwapPool(mode)
        assert host.put(pools, "pg", 3) == jhost.put(jpools, "pg", 3)
        hp, jhp = host.pages["pg"], jhost.pages["pg"]
        assert hp.crc == jhp.crc and hp.scales == jhp.scales
        for a, b in zip(hp.leaves, jhp.leaves):
            assert a.tobytes() == np.ascontiguousarray(b).tobytes()
        leaf[:, 3] = 0
        host.get(pools, "pg", 3)
        if mode == "fp16":
            assert torch.equal(leaf.view(torch.int16),
                               before.view(torch.int16))
        else:
            jpools, _ = jhost.get(jpools, "pg", 3)
            np.testing.assert_array_equal(
                leaf[:, 3].float().numpy(),
                np.asarray(jpools["layers"]["k"][:, 3], np.float32))
            leaf.copy_(before)


# ---------------------------------------------------------------------------
# write_prefill (twin of tests/test_paged_kv.py's roundtrip)
# ---------------------------------------------------------------------------

_PS, _SLOTS, _MAX = 4, 3, 16


def _wp_model():
    cfg = smoke_config("stablelm-1.6b").replace(
        num_layers=1, d_model=64, num_heads=2, num_kv_heads=2, head_dim=32,
        d_ff=128, vocab_size=128, activation_dtype="float32")
    return cfg, tf.init_params(cfg, 0, "cpu")


def test_write_prefill_matches_reference():
    """The port's ``write_prefill`` blits the same pages as the
    reference's: same prefill cache, same page table (one slot with its
    last page unmapped, whose write drops), equal pools."""
    import repro.configs as jconfigs
    cfg, _ = _wp_model()
    jc = jconfigs.smoke_config("stablelm-1.6b").replace(
        num_layers=1, d_model=64, num_heads=2, num_kv_heads=2, head_dim=32,
        d_ff=128, vocab_size=128, activation_dtype="float32")
    kv = PagedKVCache(cfg, _SLOTS, _MAX, _PS, device="cpu")
    jkv = JKV(jc, _SLOTS, _MAX, _PS)
    for k in (kv, jkv):
        k.alloc_slot(0, 10)
        k.alloc_slot(2, 12)
        k.page_table[2, 2] = k.n_pages         # unmapped: the write drops
    rng = np.random.default_rng(3)
    pc = {"layers": {"s0": {n: rng.normal(size=(1, 2, 2, 12, 32))
                            .astype(np.float32) for n in ("k", "v")}}}
    pools = kv.init_pools()
    jpools = jkv.init_pools()
    pools = kv.write_prefill(pools, bridge.cache_from_numpy(pc, "cpu"),
                             [0, 2], 10)
    jpools = jkv.write_prefill(
        jpools, {"layers": {"s0": {n: jnp.asarray(a) for n, a in
                                   pc["layers"]["s0"].items()}}}, [0, 2], 10)
    for n in ("k", "v"):
        np.testing.assert_array_equal(
            pools["layers"]["s0"][n].numpy(),
            np.asarray(jpools["layers"]["s0"][n]))


@given(seed=st.integers(0, 10_000))
@settings(max_examples=4, deadline=None)
def test_paged_roundtrip_random_interleaving(seed):
    """Random admit/evict/decode interleavings on the port: prompts enter
    their pages through ``write_prefill`` and the paged cache (with page
    reuse after eviction) gives the same logits as per-slot dense rows."""
    from repro_torch.serving.engine import _scatter_rows
    cfg, params = _wp_model()
    rng = np.random.default_rng(seed)
    kv = PagedKVCache(cfg, _SLOTS, _MAX, _PS, device="cpu")
    pools = kv.init_pools()
    dense = tf.init_cache(cfg, _SLOTS, _MAX, device="cpu")
    pos = np.zeros(_SLOTS, np.int32)
    last = np.zeros(_SLOTS, np.int32)
    active = [False] * _SLOTS

    def close(a, b):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)

    for _ in range(8):
        op = rng.choice(["admit", "decode", "decode", "evict"])
        free = [s for s in range(_SLOTS) if not active[s]]
        if op == "admit" and free:
            L = int(rng.integers(2, 7))
            if not kv.can_admit(_MAX):
                continue
            s = free[0]
            toks = torch.from_numpy(rng.integers(0, 100, (1, L)))
            kv.alloc_slot(s, _MAX)
            Lp = kv.pages_for(L) * _PS
            lg_d, pc_d = tf.prefill(params, cfg, {"tokens": toks}, _MAX)
            lg_p, pc_p = tf.prefill(params, cfg, {"tokens": toks}, Lp)
            close(lg_d, lg_p)
            _scatter_rows(dense, pc_d, torch.tensor([s]))
            pools = kv.write_prefill(pools, pc_p, [s], L)
            pos[s], last[s] = L, int(lg_d[0, 0].argmax())
            active[s] = True
        elif op == "evict":
            live = [s for s in range(_SLOTS) if active[s]]
            if not live:
                continue
            s = live[int(rng.integers(len(live)))]
            kv.free_slot(s)
            active[s], pos[s], last[s] = False, 0, 0
        elif any(active):
            toks = torch.from_numpy(last[:, None].astype(np.int64))
            q = torch.from_numpy(pos.copy())
            with torch.inference_mode():
                lg_d, dense = tf.decode_step(params, cfg, toks, dense, q)
                lg_p, pools = tf.decode_step(
                    params, cfg, toks, pools, q,
                    ctx_extra={"page_table": kv.device_page_table()})
            rows = [s for s in range(_SLOTS) if active[s]]
            close(lg_d[rows], lg_p[rows])
            nxt = lg_d[:, 0].argmax(dim=-1).numpy()
            for s in rows:
                pos[s] += 1
                last[s] = int(nxt[s])
                if pos[s] >= _MAX:
                    kv.free_slot(s)
                    active[s], pos[s], last[s] = False, 0, 0


# ---------------------------------------------------------------------------
# the oracle: random interleavings across both classes
# ---------------------------------------------------------------------------

def _interleaved(s, clock, *, ops, chunk, **kw):
    """A randomized two-class submit/step interleaving with the prefix
    cache on; returns (engine, requests in submit order)."""
    eng = par.build(s, clock, tenants=("ls0", "be0"), max_seq=MAX_SEQ,
                    paged=True, page_size=4, slots_ls=3, slots_be=3,
                    chunk_size=chunk, prefix_cache=True, **kw)
    reqs = []
    for tenant, toks, max_new, steps in ops:
        reqs.append(eng.submit(tenant, toks, max_new=max_new))
        par.step(eng, clock, steps)
    par.drive(eng, clock)
    return eng, reqs


def _random_ops(seed, n=8):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 100, 12)
    ops = []
    for _ in range(n):
        keep = int(rng.integers(1, 13))
        tail = rng.integers(0, 100, int(rng.integers(0, 4)))
        ops.append((("ls0", "be0")[int(rng.integers(2))],
                    np.concatenate([base[:keep], tail]).astype(np.int32),
                    int(rng.integers(1, 8)), int(rng.integers(0, 4))))
    return ops


_ORACLE_PRESSURE = {"events": 0, "examples": 0}


@given(seed=st.integers(0, 10_000))
@settings(max_examples=3, deadline=None)
def test_hierarchy_interleaving_oracle_fp16(seed):
    """Random interleavings of admit/decode/grow/swap-out/swap-in/preempt
    across both classes, forced by a tiny page pool: the port's tokens are
    bit-equal to its pressure-free full-reservation run in fp16 mode, and
    the pressured run equals the reference engine's."""
    tiny = par.tiny_models()
    ops = _random_ops(seed)
    chunk = int(np.random.default_rng(seed).integers(2, 7))
    _, ref_reqs = _interleaved(par.side(tiny, "port"), {"t": 0.0}, ops=ops,
                               chunk=None)
    ref, port, eng = par.run_both(tiny, _interleaved, ops=ops, chunk=chunk,
                                  kv_pages=7, grow_pages=True, swap=True,
                                  cold_dtype="fp16")
    par.assert_same(ref, port)
    assert port["tokens"] == [r.output for r in ref_reqs]
    _ORACLE_PRESSURE["examples"] += 1
    for t in ("ls0", "be0"):
        rt = eng.tenants[t]
        _ORACLE_PRESSURE["events"] += (rt.swap_outs + rt.preemptions +
                                       rt.grow_stalls + rt.prefix.evictions +
                                       rt.prefix.cold_stores)


def test_oracle_exercised_hierarchy_paths():
    """Vacuity guard for the property above: across its examples the tiny
    pool must have triggered growth/eviction/swap/preempt at least once."""
    assert _ORACLE_PRESSURE["examples"] > 0
    assert _ORACLE_PRESSURE["events"] > 0, _ORACLE_PRESSURE


@given(seed=st.integers(0, 10_000))
@settings(max_examples=2, deadline=None)
def test_hierarchy_interleaving_int8_completes(seed):
    """int8 cold tier under the same pressure: every request runs to its
    full token count, and the port's run (its quantized host pages
    included) equals the reference's."""
    ops = _random_ops(seed)
    ref, port, _ = par.run_both(par.tiny_models(), _interleaved, ops=ops,
                                chunk=3, kv_pages=9, grow_pages=True,
                                swap=True, cold_dtype="int8")
    par.assert_same(ref, port)
    for (_, _, max_new, _), toks in zip(ops, port["tokens"]):
        assert toks is not None and len(toks) == max_new


def test_int8_bounded_logits(tiny):
    """Decode logits computed from an int8-roundtripped KV pool stay close
    to the exact pool's logits (the cold tier's bounded-error contract at
    the model level)."""
    _, cfg, _, params = tiny
    cache = tf.init_paged_cache(cfg, 8, 4, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 100,
                                                              (1, 8)))
    pt = torch.arange(8, dtype=torch.int32).reshape(1, 8)
    ctx = {"page_table": pt}
    with torch.inference_mode():
        _, cache = tf.prefill_step(params, cfg, toks, cache,
                                   torch.zeros(1, dtype=torch.int32),
                                   ctx_extra=ctx)
        step = lambda c: tf.decode_step(params, cfg, torch.tensor([[5]]), c,
                                        torch.tensor([8], dtype=torch.int32),
                                        ctx_extra=ctx)[0]
        lo_exact = step(cache)
        host = HostSwapPool("int8")
        for pg in (0, 1):
            host.put(cache, ("p", pg), pg)
            host.get(cache, ("p", pg), pg)
        lo_q = step(cache)
    diff = float((lo_q - lo_exact).abs().max())
    scale = float(lo_exact.abs().max())
    assert diff <= 0.1 * scale + 0.5, (diff, scale)


# ---------------------------------------------------------------------------
# dynamic growth, preempt-restart, swap-out, the cold prefix tier
# ---------------------------------------------------------------------------

def _be_batch(s, clock, *, seed, n, max_new, **kw):
    eng = par.build(s, clock, tenants=("ls0", "be0"), max_seq=MAX_SEQ,
                    paged=True, page_size=4, slots_ls=4, slots_be=4,
                    chunk_size=4, **kw)
    reqs = [eng.submit("be0", p, max_new=max_new)
            for p in par.prompts(seed, n)]
    par.drive(eng, clock, cap=10_000)
    return eng, reqs


def test_growth_increases_admitted_slots(tiny):
    """At equal pool bytes, prompt-extent admission runs strictly more
    concurrent decode slots than full-extent reservation, with the same
    tokens; the grown run equals the reference's."""
    kw = dict(seed=2, n=6, max_new=12, kv_pages=10, prefix_cache=True)
    full_eng, full = _be_batch(par.side(tiny, "port"), {"t": 0.0}, **kw)
    ref, port, _ = par.run_both(tiny, _be_batch, grow_pages=True,
                                swap=True, cold_dtype="fp16", **kw)
    par.assert_same(ref, port)
    assert all(len(t) == 12 for t in port["tokens"])
    assert (port["tenant"]["be0"]["peak_active"]
            > full_eng.metrics()["be0"]["peak_active"])
    assert port["tokens"] == [r.output for r in full]


def test_preempt_restart_identical_tokens(tiny):
    """Swap off: pool exhaustion during growth preempts the youngest
    request back to WAITING; its restart recomputes from scratch with
    tokens identical to an uncontended run, as in the reference."""
    kw = dict(seed=4, n=5, max_new=10, grow_pages=True)
    _, clean = _be_batch(par.side(tiny, "port"), {"t": 0.0}, **kw)
    ref, port, eng = par.run_both(tiny, _be_batch, kv_pages=10, **kw)
    par.assert_same(ref, port)
    rt = eng.tenants["be0"]
    assert rt.preemptions > 0
    assert any(r.preempts > 0 for r in rt.done)
    assert port["tokens"] == [r.output for r in clean]
    assert all(len(t) == 10 for t in port["tokens"])
    assert port["tenant"]["be0"]["swap"]["preemptions"] == rt.preemptions


def test_swap_out_resumes_mid_stream(tiny):
    """Swap on: decode page groups move to the host instead of restarting
    and resume through SWAPPED -> SWAPPING exactly where they left off
    (tokens bit-equal in fp16 mode), with warm-restart gaps reported."""
    kw = dict(seed=4, n=5, max_new=10, grow_pages=True)
    _, clean = _be_batch(par.side(tiny, "port"), {"t": 0.0}, **kw)
    ref, port, eng = par.run_both(tiny, _be_batch, kv_pages=10, swap=True,
                                  cold_dtype="fp16", **kw)
    par.assert_same(ref, port)
    rt = eng.tenants["be0"]
    assert rt.swap_outs > 0 and rt.swap_ins > 0
    assert rt.preemptions == 0        # decoding victims swap, never restart
    assert port["tokens"] == [r.output for r in clean]
    sw = eng.metrics()["be0"]["swap"]
    assert sw["host"]["puts"] >= sw["host"]["gets"] > 0
    assert sw["resume"]["p99_ms"] is not None
    assert len(rt.resume_gaps) == rt.swap_ins
    assert any(q[5] for q in port["quanta"]) \
        and any(q[6] for q in port["quanta"])


def _cold_tier(s, clock, *, swap):
    eng = par.build(s, clock, tenants=("ls0", "be0"), max_seq=MAX_SEQ,
                    paged=True, page_size=4, slots_ls=4, slots_be=4,
                    kv_pages=12, prefix_cache=True, chunk_size=4,
                    grow_pages=True, swap=swap, cold_dtype="fp16")
    rt = eng.tenants["be0"]
    rng = np.random.default_rng(6)
    shared = rng.integers(0, 100, 8)
    tails = [rng.integers(0, 100, 4) for _ in range(3)]
    reqs = []
    # wave 1 populates the tree; filler traffic then evicts it
    for t in tails:
        reqs.append(eng.submit("be0", np.concatenate([shared, t]),
                               max_new=2))
    par.drive(eng, clock, cap=10_000)
    for _ in range(3):
        reqs.append(eng.submit("be0", rng.integers(200, 300, 12), max_new=2))
    par.drive(eng, clock, cap=10_000)
    mark = rt.prefill_computed
    for t in tails:
        reqs.append(eng.submit("be0", np.concatenate([shared, t]),
                               max_new=2))
    par.drive(eng, clock, cap=10_000)
    eng._wave2 = rt.prefill_computed - mark
    return eng, reqs


def test_cold_prefix_tier_saves_reprefill(tiny):
    """Zero-ref prefix leaves evicted under pressure land in the cold tier
    and fault back on the next matching admission: the second wave
    recomputes fewer prompt tokens than with the cold tier off; the run
    with it on equals the reference's."""
    ref, port, eng = par.run_both(tiny, _cold_tier, swap=True)
    par.assert_same(ref, port)
    off, _ = _cold_tier(par.side(tiny, "port"), {"t": 0.0}, swap=False)
    assert eng.tenants["be0"].prefix.cold_faults > 0
    assert eng._wave2 < off._wave2, (eng._wave2, off._wave2)


# ---------------------------------------------------------------------------
# PCIe: swap flows share the CFS with weight streaming
# ---------------------------------------------------------------------------

def test_swap_and_weight_streams_share_cfs(tiny):
    """KV page-swap flows and model-weight streaming contend on the same
    PCIe CFS: two saturating flows with nice 3:1 converge to ~3:1
    bandwidth, and the port's completions equal the reference's."""
    jcfg, cfg, _, _ = tiny
    out = []
    for mods in ((pcie, model_bytes, swap_requests, page_swap_requests, cfg),
                 (jpcie, jserving.model_bytes, jserving.swap_requests,
                  jserving.page_swap_requests, jcfg)):
        pc, mb, sr, psr, c = mods
        bus = pc.BusSpec()
        H = 0.05
        n_wt = int(H * bus.bw_h2d / mb(c)) + 4
        weights = sr(c, "wt0", "BE", 3, [0.0] * n_wt)
        page_b = 1 << 20
        pages = psr("kv0", "BE", 1, page_bytes=page_b,
                    n_pages=int(H * bus.bw_h2d / page_b) + 4,
                    direction="h2d", arrivals=[0.0])
        comps = [c for c in pc.PCIeCFS(2048).run(weights + pages, bus,
                                                 "h2d") if c.t_done < H]
        by = {}
        for c in comps:
            by[c.req.tenant] = by.get(c.req.tenant, 0) + c.req.size
        out.append((by, [(c.req.rid, c.t_start, c.t_done) for c in comps]))
    assert out[0] == out[1]
    by = out[0][0]
    assert by.get("wt0") and by.get("kv0")
    assert 1.5 < by["wt0"] / by["kv0"] < 6.0
