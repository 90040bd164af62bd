"""The model families of ``ARCHS`` on the port, and the MoE and MLA families
through the port's engine, against the reference.

Twins of ``tests/test_models_smoke.py`` for all ten configs: forward
shapes without NaN, and step-by-step ``decode_step`` reproducing
``forward`` within the reference's own 2e-3 (f32 smoke configs; image
features and audio frames from ``models.io.make_batch``; the VLM's cross
gates opened to 0.5, since a zero gate, the init, would hide the cross
layers). Then the four families this slice adds, against the reference on
the port's seeded weights (``repro_torch.bridge``): ``forward`` logits
and aux, ``prefill_step``/``decode_step`` logits and caches for the MoE
and MLA decoders (dense and paged, a sentinel row), ``prefill`` with
frames or image features and a ``decode_step`` with them in
``ctx_extra`` for the encoder and vision models, and the input fields.

``FWD_TOL``: both sides compute in f32, so the logits differ by summation
order only, which depth amplifies. Over 24 draws (seeds 0-23 of the port's
init, a fresh batch each) the largest forward-logit error against the
reference was 7.2e-5 for moonshot (median 1.6e-5), 1.8e-5 for deepseek
(7.1e-6), 6.2e-4 for whisper-small (1.6e-4; 4 layers over 12 frames) and
1.9e-3 for llama-3.2-vision (1.2e-4; 10 layers, cross gates 0.5). Each
atol is about 3x the worst draw, with rtol 1e-4.

The engine tests serve LS deepseek-v2 smoke + BE moonshot smoke on the
port's engine and the reference's, on one virtual clock
(``_torch_serving_parity``), dense and paged, and once paged with the
prefix cache and the host swap tier: tokens, events, the quantum log and
the tenants' metrics must be equal (host pages within moonshot's
``FWD_TOL``). MLA latent pools go through ``write_prefill`` and the
copy-on-write page copy equal to the reference's, and both families
through the disaggregated engine's wire with the reference's outputs and
flow schedule.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_serving_parity as par  # noqa: E402

from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.models import io as jio  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ARCHS, smoke_config  # noqa: E402
from repro_torch.models import io, transformer as tf  # noqa: E402

ALL = sorted(ARCHS)
NEW = ("deepseek-v2-236b", "llama-3.2-vision-90b", "moonshot-v1-16b-a3b",
       "whisper-small")
FWD_TOL = {"moonshot-v1-16b-a3b": dict(rtol=1e-4, atol=2e-4),
           "deepseek-v2-236b": dict(rtol=1e-4, atol=6e-5),
           "whisper-small": dict(rtol=1e-4, atol=2e-3),
           "llama-3.2-vision-90b": dict(rtol=1e-4, atol=6e-3)}
SMAX, PS, P = 24, 4, 6
ENGINE_PAIR = {"ls0": "deepseek-v2-236b", "be0": "moonshot-v1-16b-a3b"}


def _open_gates(params, value=0.5):
    """Cross layers' tanh gates (zeros at init) set to ``value``."""
    for slot in params.get("layers", {}).values():
        if "gate" in slot.get("attn", {}):
            slot["attn"]["gate"].fill_(value)
    return params


def _model(name, seed=0):
    cfg = smoke_config(name)
    return cfg, _open_gates(tf.init_params(cfg, seed, "cpu"))


def _batch(cfg, B, S, seed=0):
    return io.make_batch(cfg, B, S, torch.Generator().manual_seed(seed),
                         with_labels=False)


def _j(x):
    return jax.tree.map(jnp.asarray, bridge.to_numpy(x))


def _close(got, want, tol):
    np.testing.assert_allclose(bridge.to_numpy(got), np.asarray(want), **tol)


# ---------------------------------------------------------------------------
# twins of test_models_smoke.py, all ten configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ALL)
def test_forward_shapes_no_nans(name):
    cfg, params = _model(name)
    logits, aux = tf.forward(params, cfg, _batch(cfg, 2, 16))
    assert logits.shape == (2, 16, cfg.vocab_size)
    assert not bool(torch.isnan(logits).any())
    assert set(aux) == ({"z_loss", "lb_loss", "dropped_frac"} if cfg.moe
                        else set())


@pytest.mark.parametrize("name", ALL)
def test_decode_matches_forward(name):
    """Step-by-step decode reproduces the full forward logits."""
    cfg, params = _model(name, seed=2)
    S = 8
    batch = _batch(cfg, 1, S, seed=1)
    full, _ = tf.forward(params, cfg, batch)
    cache = tf.init_cache(cfg, 1, S, device="cpu")
    ctx = tf._context(params, cfg, batch)
    outs = []
    for t in range(S):
        logits, cache = tf.decode_step(params, cfg,
                                       batch["tokens"][:, t:t + 1], cache,
                                       torch.tensor(t, dtype=torch.int32),
                                       ctx_extra=ctx)
        outs.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("name", ALL)
def test_batch_fields_match_reference(name):
    """The port's input fields are the reference's (names, shapes, dtypes),
    and a batch is a function of its generator's seed."""
    cfg = smoke_config(name)
    got = [(n, s, str(d).split(".")[-1])
           for n, s, d in io.batch_fields(cfg, 2, 5)]
    want = [(n, s, np.dtype(d).name)
            for n, s, d in jio.batch_fields(jsmoke(name), 2, 5)]
    assert got == want
    a, b = _batch(cfg, 2, 5, seed=3), _batch(cfg, 2, 5, seed=3)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert int(a["tokens"].max()) < cfg.vocab_size


# ---------------------------------------------------------------------------
# the new families against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    out = {}
    for name in NEW:
        cfg, tp = _model(name)
        out[name] = (jsmoke(name), cfg, _j(tp), tp)
    return out


@pytest.mark.parametrize("name", NEW)
def test_params_structure_matches_reference(name, models):
    """The same tree, shapes and dtypes as the reference's init (the MoE
    router an f32 leaf)."""
    jcfg, cfg, jp, _ = models[name]
    mine = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jp)
    ref = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                       jax.eval_shape(lambda k: jtf.init_params(k, jcfg),
                                      jax.random.key(0)))
    assert mine == ref


@pytest.mark.parametrize("name", NEW)
def test_forward_matches_reference(name, models):
    jcfg, cfg, jp, tp = models[name]
    batch = _batch(cfg, 2, 8, seed=4)
    jl, jaux = jtf.forward(jp, jcfg, _j(batch))
    tl, aux = tf.forward(tp, cfg, batch)
    _close(tl, jl, FWD_TOL[name])
    assert aux.keys() == jaux.keys()
    for k in aux:
        if k == "dropped_frac":        # a sum of exact fractions
            assert float(aux[k]) == float(jaux[k])
        else:
            _close(aux[k], jaux[k], dict(rtol=1e-5, atol=1e-7))


def _step_inputs(cfg, paged):
    """prefill Sq=8, prefill Sq=3, decode; row 2 at the write sentinel."""
    rng = np.random.default_rng(5)
    sentinel = P * PS if paged else SMAX
    return [(rng.integers(0, cfg.vocab_size, (3, Sq)).astype(np.int32),
             np.asarray(pos, np.int32))
            for Sq, pos in ((8, [0, 5, sentinel]), (3, [8, 13, sentinel]),
                            (1, [11, 16, sentinel]))]


def _page_table(n_pages=16):
    pt = np.full((3, P), n_pages, np.int32)
    pt[0] = [3, 7, 1, 12, 0, 9]
    pt[1] = [2, 15, 4, 6, 11, 5]
    return pt


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("name", ["deepseek-v2-236b", "moonshot-v1-16b-a3b"])
def test_steps_match_reference(name, paged, models):
    """prefill_step Sq=8, Sq=3, decode_step: logits and the whole cache
    after each call (MLA latents for deepseek, K/V for moonshot), with
    ``use_flash`` on (MLA takes no kernel; moonshot's GQA takes the plain
    versions on the CPU)."""
    jcfg, cfg, jp, tp = models[name]
    tol = FWD_TOL[name]
    if paged:
        jcache = jtf.init_paged_cache(jcfg, 16, PS)
        jctx = {"page_table": jnp.asarray(_page_table())}
        tctx = {"page_table": torch.from_numpy(_page_table())}
    else:
        jcache, jctx, tctx = jtf.init_cache(jcfg, 3, SMAX), None, None
    tcache = bridge.cache_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    jsteps = {one: jax.jit(lambda p, t, c, q, f=(jtf.decode_step if one else
                                                  jtf.prefill_step):
                           f(p, jcfg, t, c, q, ctx_extra=jctx))
              for one in (False, True)}
    for toks, pos in _step_inputs(cfg, paged):
        one = toks.shape[1] == 1
        fn = tf.decode_step if one else tf.prefill_step
        jl, jcache = jsteps[one](jp, jnp.asarray(toks), jcache,
                                 jnp.asarray(pos))
        tl, tcache = fn(tp, cfg, torch.from_numpy(toks), tcache,
                        torch.from_numpy(pos), ctx_extra=tctx,
                        use_flash=True)
        _close(tl, jl, tol)
        want = jax.tree.map(np.asarray, jcache)
        got = bridge.to_numpy(tcache)
        jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, **tol),
                     got, want)


@pytest.mark.parametrize("name", ["llama-3.2-vision-90b", "whisper-small"])
def test_context_prefill_and_decode_match_reference(name, models):
    """``prefill`` with frames / image features in the batch, then one
    ``decode_step`` with the context in ``ctx_extra`` (``enc_out``, the
    encoder run once, for whisper): logits and caches."""
    jcfg, cfg, jp, tp = models[name]
    tol = FWD_TOL[name]
    batch = _batch(cfg, 2, 6, seed=6)
    jl, jcache = jtf.prefill(jp, jcfg, _j(batch), 8)
    tl, tcache = tf.prefill(tp, cfg, batch, 8)
    _close(tl, jl, tol)
    ctx = {"vision": batch["vision"]} if cfg.vision else {
        "enc_out": tf._run_encoder(tp, cfg, batch["frames"])}
    jctx = {k: jnp.asarray(bridge.to_numpy(v)) for k, v in ctx.items()}
    tok = np.asarray([[3], [7]], np.int32)
    jl, jcache = jtf.decode_step(jp, jcfg, jnp.asarray(tok), jcache,
                                 jnp.asarray(6, jnp.int32), ctx_extra=jctx)
    tl, tcache = tf.decode_step(tp, cfg, torch.from_numpy(tok), tcache,
                                torch.tensor(6, dtype=torch.int32),
                                ctx_extra=ctx, use_flash=True)
    _close(tl, jl, tol)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, **tol),
                 bridge.to_numpy(tcache), jax.tree.map(np.asarray, jcache))


# ---------------------------------------------------------------------------
# LS deepseek-v2 + BE moonshot through both engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    return par.family_models(tuple(ENGINE_PAIR.values()))


def _pair_run(s, clock, *, prompts, **kw):
    eng = par.build(s, clock, tenants=tuple(ENGINE_PAIR), max_seq=32,
                    page_size=4, chunk_size=5, slots_ls=2, slots_be=3,
                    use_flash=True, **kw)
    reqs = [eng.submit("ls0" if i % 3 == 0 else "be0", p, max_new=4)
            for i, p in enumerate(prompts)]
    par.drive(eng, clock)
    return eng, reqs


def _both(pair, **kw):
    snaps = []
    for name in ("ref", "port"):
        eng, reqs = _pair_run(par.side_of(pair, ENGINE_PAIR, name),
                              {"t": 0.0}, **kw)
        snaps.append(par.snapshot(eng, reqs))
    return snaps[0], snaps[1], eng


@pytest.mark.parametrize("paged", [False, True])
def test_engine_pair_matches_reference(pair, paged):
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 500, int(rng.integers(3, 14)))
               for _ in range(7)]
    ref, port, eng = _both(pair, prompts=prompts, paged=paged)
    par.assert_same(ref, port)
    assert all(t is not None and len(t) == 4 for t in port["tokens"])
    assert {q[1] for q in port["quanta"]} == {"LS", "BE"}


def test_engine_pair_prefix_swap_matches_reference(pair):
    """Paged with the prefix cache and the host swap tier over a tight
    pool (6 pages a tenant): shared-prefix prompts (some repeated) hit in
    both tenants, and growth swaps both tenants' requests out and back,
    so the latent (MLA) and K/V pages travel through the host tier
    alike."""
    rng = np.random.default_rng(8)
    base = rng.integers(0, 500, 8)
    prompts = [np.concatenate([base, rng.integers(0, 500, 3)])
               for _ in range(10)]
    for a, b in ((0, 3), (1, 4), (6, 9), (2, 5)):
        prompts[b] = prompts[a].copy()
    ref, port, eng = _both(pair, prompts=prompts, paged=True,
                           prefix_cache=True, grow_pages=True, swap=True,
                           cold_dtype="fp16", kv_pages=6)
    # host pages hold K/V and latents after MoE layers: FWD_TOL's atol
    par.assert_same(ref, port, page_tol=FWD_TOL["moonshot-v1-16b-a3b"]
                    ["atol"])
    for t in port["tenant"].values():
        assert t["prefix_cache"]["hits"] > 0 and t["swap"]["swap_outs"] > 0


def test_latent_pages_blit_and_fork_match_reference(pair):
    """MLA latent pools ([n_pages, page, R], the page axis where GQA has
    it) through ``write_prefill`` (one slot's last page unmapped: its
    write drops) and the copy-on-write page copy, equal to the
    reference's."""
    from repro.serving.kv_cache import (PagedKVCache as JKV,
                                        _copy_page_tree as j_copy)
    from repro_torch.serving.kv_cache import PagedKVCache, _copy_page_tree
    jcfg, cfg = pair["deepseek-v2-236b"][:2]
    kv = PagedKVCache(cfg, 3, 16, 4, device="cpu")
    jkv = JKV(jcfg, 3, 16, 4)
    for k in (kv, jkv):
        k.alloc_slot(0, 10)
        k.alloc_slot(2, 12)
        k.page_table[2, 2] = k.n_pages
    rng = np.random.default_rng(4)
    m = cfg.mla
    dense = {"prefix": [{"ckv": rng.normal(size=(2, 12, m.kv_lora_rank)),
                         "krope": rng.normal(size=(2, 12,
                                                   m.qk_rope_head_dim))}],
             "layers": {"s0": {
                 "ckv": rng.normal(size=(2, 2, 12, m.kv_lora_rank)),
                 "krope": rng.normal(size=(2, 2, 12, m.qk_rope_head_dim))}}}
    dense = jax.tree.map(lambda a: a.astype(np.float32), dense)
    pools = kv.write_prefill(kv.init_pools(),
                             bridge.cache_from_numpy(dense, "cpu"), [0, 2],
                             10)
    jpools = jkv.write_prefill(jkv.init_pools(),
                               jax.tree.map(jnp.asarray, dense), [0, 2], 10)
    src, dst = int(kv.page_table[0, 1]), int(kv.free_list[-1])
    pools = _copy_page_tree(pools, src, dst)
    jpools = j_copy(jpools, src, dst)
    jax.tree.map(np.testing.assert_array_equal, bridge.to_numpy(pools),
                 jax.tree.map(np.asarray, jpools))
    assert pools["layers"]["s0"]["ckv"].shape == (2, kv.n_pages, 4,
                                                  m.kv_lora_rank)
    assert bool(pools["prefix"][0]["ckv"][dst].abs().sum() > 0)


def _disagg_pair(side, pair):
    """LS deepseek-v2 (MLA) and LS moonshot (GQA + MoE) smoke tenants on
    a 4-device host star, 2 prefilling: their pages cross the wire."""
    from repro_torch.serving import DisaggregatedEngine
    import repro.serving as jserving
    s = par.side_of(pair, {"ls0": "deepseek-v2-236b",
                           "ls1": "moonshot-v1-16b-a3b"}, side)
    Eng = (jserving.DisaggregatedEngine if side == "ref"
           else DisaggregatedEngine)
    dis = Eng(max_seq=32, page_size=4, chunk_size=4, n_devices=4,
              n_prefill=2, seed=5, **s.kw)
    for name, (cfg, params) in s.models.items():
        dis.add_tenant(s.Spec(name, "LS"), cfg, params=params)
    rng = np.random.default_rng(29)
    for i, L in enumerate((11, 6, 15, 9)):
        dis.submit(("ls0", "ls1")[i % 2], rng.integers(1, 60, L).tolist(),
                   max_new=4)
    dis.run_until_idle(max_rounds=5000)
    m = dis.metrics()
    return {"fingerprint": dis.fingerprint(),
            "interconnect": m["interconnect"],
            "migrations": m["migrations"]}


def test_disagg_pair_matches_reference(pair):
    """The disaggregated engine with an MLA and an MoE tenant: outputs,
    the flow schedule (its sizes are the tenants' page bytes), lending and
    migrations equal to the reference's."""
    ref, port = _disagg_pair("ref", pair), _disagg_pair("port", pair)
    assert ref["migrations"]["delivered"] == 4
    assert port == ref
