"""The port's MoE layer, MLA and cross-attention against the reference, on
the f32 smoke configs of ``moonshot-v1-16b-a3b`` (GQA + MoE: 8 experts
top-2, one shared expert), ``deepseek-v2-236b`` (MLA + MoE) and
``llama-3.2-vision-90b`` (gated cross-attention). Both sides get the port's
seeded weights through ``repro_torch.bridge``.

MoE routing is compared exactly: the top-k experts (the reference's, read
off its ``jax.lax.top_k`` call), the keep masks (an oracle that counts each
expert's slots in k-major order) and ``dropped_frac``, at capacity factors
0.5 and 1.0 over 64 tokens, where slots are dropped. The output and the
z/load-balance losses agree within ``TOL`` (1e-5: f32 sums of a few
products in another order). The smallest gap between a token's k-th and
(k+1)-th router probability in those inputs is 1.2e-4 (moonshot) and
2.0e-4 (deepseek), three orders over f32 rounding of a probability, so the
comparison sees no tie; ties themselves go to the lower expert index on
both sides (``test_topk_ties_to_lower_index``). ``route_plain`` and
``moe_forward_plain`` share no code with ``moe_forward`` (argmax rounds,
a per-expert loop, a per-token combine): the same experts, positions and
keep masks bit for bit, gates, output and aux within ``TOL``.

Each MLA function runs on a batch with a sentinel row (position past the
window) and, paged, a page table with unmapped entries; outputs and every
cache entry are held within ``TOL``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro_torch import bridge
from repro_torch.configs import smoke_config
from repro_torch.models import attention as attn
from repro_torch.models import common
from repro_torch.models import moe
from repro_torch.serving.kv_cache import kv_bytes_per_token

TOL = dict(rtol=1e-5, atol=1e-5)
MOE_NAMES = ("moonshot-v1-16b-a3b", "deepseek-v2-236b")
CFS = (0.5, 1.0)
SMAX, PS, P, NPAGES = 24, 4, 6, 16


def _j(tree):
    return jax.tree.map(jnp.asarray, bridge.to_numpy(tree))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(bridge.to_numpy(got), np.asarray(want), **tol)


def _moe_case(name, cf, seed=0):
    seed += 10 * MOE_NAMES.index(name)     # the two smoke MoEs' shapes agree
    cfg = smoke_config(name)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    p = moe.init_moe(seed, "m", cfg, torch.float32, "cpu")
    x = np.random.default_rng(seed + 1).standard_normal(
        (4, 16, cfg.d_model)).astype(np.float32)
    return cfg, jsmoke(name).replace(moe=cfg.moe), p, x


def _ref_topk(monkeypatch, jp, x, jcfg):
    """The reference's ``moe_forward`` with the top-k experts it picked
    (k-major), read off its ``jax.lax.top_k`` call."""
    seen = []
    top_k = jax.lax.top_k

    def rec(a, k):
        out = top_k(a, k)
        seen.append(np.asarray(out[1]))
        return out
    with monkeypatch.context() as mp:
        mp.setattr(jax.lax, "top_k", rec)
        jy, jaux = jmoe.moe_forward(jp, jnp.asarray(x), jcfg)
    return jy, jaux, seen[0].T.reshape(-1)


def _keep_oracle(idx, C, E):
    """k-major slots: the first C slots of each expert are kept."""
    seen = np.zeros(E, int)
    keep = np.zeros(idx.size, bool)
    for i, e in enumerate(idx):
        keep[i] = seen[e] < C
        seen[e] += 1
    return keep


def test_capacity_matches_reference():
    cfg = smoke_config("moonshot-v1-16b-a3b")
    for cf in (0.25, 0.5, 1.0, 1.25, 2.0):
        m = dataclasses.replace(cfg.moe, capacity_factor=cf)
        for T in (1, 3, 8, 24, 64, 100, 2048):
            assert moe.capacity(m, T) == jmoe._capacity(m, T)


@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("name", MOE_NAMES)
def test_moe_forward_matches_reference(name, cf, monkeypatch):
    cfg, jcfg, p, x = _moe_case(name, cf)
    jy, jaux, ref_idx = _ref_topk(monkeypatch, _j(p), x, jcfg)
    y, aux = moe.moe_forward(p, torch.from_numpy(x), cfg)
    r = moe.route(p, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(r.idx.numpy(), ref_idx)
    keep = _keep_oracle(ref_idx, r.C, cfg.moe.num_experts)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    assert not keep.all()                            # drops present
    assert float(aux["dropped_frac"]) == float(jaux["dropped_frac"])
    assert float(aux["dropped_frac"]) == 1.0 - keep.mean(dtype=np.float32)
    _close(y, jy)
    for k in ("z_loss", "lb_loss"):
        _close(aux[k], jaux[k])


@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("name", MOE_NAMES)
def test_moe_plain_equals_batched(name, cf):
    cfg, _, p, x = _moe_case(name, cf, seed=3)
    xt = torch.from_numpy(x)
    y, aux = moe.moe_forward(p, xt, cfg)
    yp, auxp, rp = moe.moe_forward_plain(p, xt, cfg)
    r = moe.route(p, xt, cfg)
    for a, b in zip((r.idx, r.pos, r.keep), (rp.idx, rp.pos, rp.keep)):
        assert torch.equal(a, b)
    assert r.C == rp.C and not bool(r.keep.all())
    _close(rp.gates, r.gates.numpy())
    _close(yp, y.numpy())
    assert aux.keys() == auxp.keys()
    for k in aux:
        _close(auxp[k], aux[k].numpy())
    # a kept slot's gate zeroed moves its token's output
    slot = int(torch.nonzero(rp.keep)[0])
    bad = rp._replace(gates=rp.gates.clone().index_fill_(0,
                                                         torch.tensor(slot),
                                                         0.0))
    yb, _, _ = moe.moe_forward_plain(p, xt, cfg, routing=bad)
    t = slot % (x.shape[0] * x.shape[1])
    assert float((yb - y).reshape(-1, cfg.d_model)[t].abs().max()) > 1e-3


@pytest.mark.parametrize("name", MOE_NAMES)
def test_routing_gap_excludes_ties(name):
    """The parity inputs' smallest gap between the k-th and (k+1)-th router
    probability, far above f32 rounding (see the module docstring)."""
    gaps = []
    for cf in CFS:
        for seed in (0, 3):
            cfg, _, p, x = _moe_case(name, cf, seed)
            probs = torch.softmax(torch.from_numpy(x).reshape(
                -1, cfg.d_model) @ p["router"], dim=-1)
            top = torch.sort(probs, dim=-1, descending=True).values
            K = cfg.moe.top_k
            gaps.append(float((top[:, K - 1] - top[:, K]).min()))
    assert min(gaps) > 1e-4, min(gaps)


def test_topk_ties_to_lower_index(monkeypatch):
    """A router whose columns repeat gives exactly tied probabilities: both
    sides pick the lower expert index first."""
    cfg, jcfg, p, x = _moe_case("moonshot-v1-16b-a3b", 1.25)
    r = p["router"]
    r[:, 4:] = r[:, :4]                      # experts e and e + 4 tie
    _, _, ref_idx = _ref_topk(monkeypatch, _j(p), x, jcfg)
    idx = moe.route(p, torch.from_numpy(x), cfg).idx.numpy()
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_array_equal(
        moe.route_plain(p, torch.from_numpy(x), cfg).idx.numpy(), ref_idx)
    assert (idx.reshape(2, -1)[0] < 4).all()
    assert (idx.reshape(2, -1)[1] == idx.reshape(2, -1)[0] + 4).all()


def test_dense_init_sliced():
    """Drawn one slice at a time into the target dtype: deterministic in
    (seed, path), each slice its own draw, fan-in shape[-2]."""
    a = common.dense_init_sliced(3, "x/w", (3,), (4, 64, 32), torch.bfloat16,
                                 "cpu")
    b = common.dense_init_sliced(3, "x/w", (3,), (4, 64, 32), torch.bfloat16,
                                 "cpu")
    assert a.shape == (3, 4, 64, 32) and a.dtype == torch.bfloat16
    assert torch.equal(a, b)
    assert not torch.equal(a[0], a[1])
    assert torch.equal(a[2], common.dense_init(3, "x/w/2", (4, 64, 32),
                                               torch.bfloat16, "cpu"))
    assert abs(float(a.float().std()) * 64 ** 0.5 - 0.88) < 0.05


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mla():
    cfg = smoke_config("deepseek-v2-236b")
    p = attn.init_mla(0, "m", cfg, torch.float32, "cpu")
    return cfg, jsmoke("deepseek-v2-236b"), p, _j(p)


def test_init_mla_fan_in_quirk(mla):
    """The reference's fan-in is shape[-2]: H (4) for wq_b [R_q, H, qk]."""
    cfg, _, p, _ = mla
    std = float(p["wq_b"].std()) * cfg.num_heads ** 0.5
    assert abs(std - 0.88) < 0.05


def test_mla_forward_matches_reference(mla):
    cfg, jcfg, p, jp = mla
    x = np.random.default_rng(4).standard_normal(
        (2, 9, cfg.d_model)).astype(np.float32)
    want = jattn.mla_forward(jp, jnp.asarray(x), jcfg)
    _close(attn.mla_forward(p, torch.from_numpy(x), cfg), want)


def _latents(cfg, rng, lead):
    m = cfg.mla
    return (rng.standard_normal(lead + (m.kv_lora_rank,)).astype(np.float32),
            rng.standard_normal(lead + (m.qk_rope_head_dim,))
            .astype(np.float32))


def _page_table():
    """Row 0 and 1 mapped (with an unmapped tail on row 1), row 2 free."""
    pt = np.full((3, P), NPAGES, np.int32)
    pt[0] = [3, 7, 1, 12, 0, 9]
    pt[1, :4] = [2, 15, 4, 6]
    return pt


CASES = {
    # name: (Sq, pos, paged); row 2 sits at the write sentinel
    "prefill_step": (5, [0, 9, SMAX], False),
    "decode_vector": (1, [3, 17, SMAX], False),
    "decode_scalar": (1, 11, False),
    "prefill_paged": (5, [2, 13, P * PS], True),
    "decode_paged": (1, [6, 15, P * PS], True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mla_steps_match_reference(mla, case):
    """Each cached MLA function: output and the whole latent cache after
    the call, dense or paged."""
    cfg, jcfg, p, jp = mla
    Sq, pos, paged = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    x = rng.standard_normal((3, Sq, cfg.d_model)).astype(np.float32)
    ckv, kr = _latents(cfg, rng, (NPAGES, PS) if paged else (3, SMAX))
    pos_np = np.asarray(pos, np.int32)
    t = lambda a: torch.from_numpy(a.copy())
    if paged:
        pt = _page_table()
        jfn = jattn.mla_prefill_paged if Sq > 1 else jattn.mla_decode_paged
        fn = attn.mla_prefill_paged if Sq > 1 else attn.mla_decode_paged
        want = jfn(jp, jnp.asarray(x), jcfg, jnp.asarray(ckv), jnp.asarray(kr),
                   jnp.asarray(pt), jnp.asarray(pos_np))
        got = fn(p, t(x), cfg, t(ckv), t(kr), t(pt), t(pos_np))
    else:
        jfn = jattn.mla_prefill_step if Sq > 1 else jattn.mla_decode
        fn = attn.mla_prefill_step if Sq > 1 else attn.mla_decode
        want = jfn(jp, jnp.asarray(x), jcfg, jnp.asarray(ckv), jnp.asarray(kr),
                   jnp.asarray(pos_np))
        got = fn(p, t(x), cfg, t(ckv), t(kr), t(pos_np))
    for g, w in zip(got, want):
        _close(g, w)
    if not paged and np.ndim(pos):       # the sentinel row writes nothing
        np.testing.assert_array_equal(got[1][2].numpy(), ckv[2])


def test_mla_dus_fast_path_bit_equal(mla):
    """A scalar ``pos`` and the same position per row leave bit-equal
    outputs and caches; at ``pos == Smax`` nothing is written."""
    cfg, _, p, _ = mla
    g = torch.Generator().manual_seed(0)
    B, Smax = 2, 12
    x = torch.randn((B, 1, cfg.d_model), generator=g)
    ckv = torch.randn((B, Smax, cfg.mla.kv_lora_rank), generator=g)
    kr = torch.randn((B, Smax, cfg.mla.qk_rope_head_dim), generator=g)
    for pos in (0, 7, Smax - 1, Smax):
        o1, c1, r1 = attn.mla_decode(p, x, cfg, ckv.clone(), kr.clone(),
                                     torch.tensor(pos))
        o2, c2, r2 = attn.mla_decode(p, x, cfg, ckv.clone(), kr.clone(),
                                     torch.full((B,), pos, dtype=torch.int32))
        for a, b in ((o1, o2), (c1, c2), (r1, r2)):
            assert torch.equal(a, b)
        if pos == Smax:
            assert torch.equal(c1, ckv) and torch.equal(r1, kr)


def test_kv_bytes_per_token_mla():
    """MLA caches R + rope latent values a token a layer."""
    cfg = smoke_config("deepseek-v2-236b")
    m = cfg.mla
    per = (m.kv_lora_rank + m.qk_rope_head_dim) * 4
    assert kv_bytes_per_token(cfg, 4) == per * cfg.num_layers
    assert kv_bytes_per_token(cfg) == per * cfg.num_layers     # f32 smoke


# ---------------------------------------------------------------------------
# cross-attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gated", [False, True])
def test_cross_attn_matches_reference(gated):
    cfg = smoke_config("llama-3.2-vision-90b")
    jcfg = jsmoke("llama-3.2-vision-90b")
    kv_dim = cfg.vision.vision_dim
    p = attn.init_cross_attn(1, "c", cfg, kv_dim, torch.float32, "cpu")
    p["gate"].fill_(0.6)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    feats = rng.standard_normal((2, 8, kv_dim)).astype(np.float32)
    want = jattn.cross_attn_forward(_j(p), jnp.asarray(x), jnp.asarray(feats),
                                    jcfg, gated=gated)
    got = attn.cross_attn_forward(p, torch.from_numpy(x),
                                  torch.from_numpy(feats), cfg, gated=gated)
    _close(got, want)
