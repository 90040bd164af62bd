"""The port's query-blocked attention (``models/attention.py::
blocked_attention``, taken by ``gqa_forward`` and ``mla_forward`` above
``BLOCKED_THRESHOLD`` = 2048 tokens) against the reference's, in f32.

The kernel-level cases (S 2560 and 4096; causal, non-causal, a local
window, a logit softcap, G > 1, a nonzero ``q_offset``) give both sides
the same q, k, v from a seeded numpy generator. ``gqa_forward`` (qwen3 and
gemma2 smoke widths, local and global layers) and ``mla_forward``
(deepseek-v2 smoke) get the port's seeded weights on both sides through
``repro_torch.bridge``.

Tolerance ``TOL``: rtol 1e-5 and atol 1e-5 scaled by ``max(1,
max|want|)``, as in ``test_torch_moe_mla.py``: both sides compute in f32
and differ by their summation orders (the port's causal blocks also read
only the keys up to their last row, a shorter sum of the same terms).

At S 2049 and 3000, where 512 does not divide S, the blocked path is held
against the port's own unblocked ``grouped_attention`` on the same
inputs: the reference asserts ``Sq % block_q == 0`` there (its
``gqa_forward`` raises ``AssertionError`` at S 2049, recorded below), the
port runs a shorter last block.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.models import attention as jattn
from repro_torch import bridge
from repro_torch.configs import smoke_config
from repro_torch.models import attention as attn
from repro_torch.models.common import causal_mask, local_mask

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Small shapes and many small ops: two intra-op threads, so that the
    suite's parallel workers do not oversubscribe the cores (with all of
    them, this file ran 20-35x slower beside five other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(bridge.to_numpy(got), want,
                               rtol=tol["rtol"], atol=tol["atol"] * scale)


# name: (H, Hkv, causal, window, cap, q_offset)
CASES = {
    "causal": (2, 2, True, None, None, 0),
    "non_causal": (2, 2, False, None, None, 0),
    "window": (2, 2, True, 700, None, 0),
    "cap": (2, 2, True, None, 5.0, 0),
    "gqa": (4, 1, True, None, None, 0),
    "q_offset": (2, 1, True, None, None, 512),
}
DH = 16


def _qkv(S, H, Hkv, q_offset, seed, Dh=DH):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, S, H, Dh)).astype(np.float32)
    k = rng.standard_normal((1, S + q_offset, Hkv, Dh)).astype(np.float32)
    v = rng.standard_normal((1, S + q_offset, Hkv, Dh)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("S", [2560, 4096])
def test_blocked_matches_reference(S, case):
    H, Hkv, causal, window, cap, q_offset = CASES[case]
    q, k, v = _qkv(S, H, Hkv, q_offset, sorted(CASES).index(case))
    kw = dict(causal=causal, window=window, cap=cap, q_offset=q_offset)
    want = jattn.blocked_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), **kw)
    got = attn.blocked_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    assert got.shape == (1, S, H, DH) and got.dtype == torch.float32
    _close(got, want)


def _unblocked(q, k, v, causal, window, cap):
    S = q.shape[1]
    if not causal:
        mask = None
    elif window:
        mask = local_mask(S, S, window)
    else:
        mask = causal_mask(S, S)
    return attn.grouped_attention(q, k, v, mask, cap)


@pytest.mark.parametrize("case", ["causal", "window", "cap", "gqa",
                                  "non_causal"])
@pytest.mark.parametrize("S", [2049, 3000])
def test_ragged_blocked_equals_unblocked(S, case):
    """A last block of S % 512 rows (1 at S 2049, 440 at 3000)."""
    H, Hkv, causal, window, cap, _ = CASES[case]
    q, k, v = map(torch.from_numpy, _qkv(S, H, Hkv, 0, S + len(case)))
    got = attn.blocked_attention(q, k, v, causal=causal, window=window,
                                 cap=cap)
    want = _unblocked(q, k, v, causal, window, cap)
    _close(got, want.numpy())


def test_blocked_before_position_zero_reads_every_key():
    """Rows at negative positions (q_offset < 0) see no key: a uniform
    softmax over all of them, as the reference computes; a later block
    reads only the keys up to its last row."""
    q, k, v = _qkv(2048, 2, 2, 0, 7)
    kw = dict(causal=True, q_offset=-700, block_q=512)
    want = jattn.blocked_attention(*map(jnp.asarray, (q, k, v)), **kw)
    got = attn.blocked_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    _close(got, want)
    np.testing.assert_allclose(got[0, 0].numpy(),
                               np.broadcast_to(v[0].mean(0), (2, DH)),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# through the model's attention entry points
# ---------------------------------------------------------------------------

def _x(cfg, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (1, S, cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def gqa_params():
    out = {}
    for name in ("qwen3-1.7b", "gemma2-9b"):
        cfg = smoke_config(name)
        p = attn.init_gqa(3, "a", cfg, torch.float32, "cpu")
        if cfg.qk_norm:
            for g in ("q_gamma", "k_gamma"):
                p[g] = 0.1 * torch.randn(p[g].shape,
                                         generator=torch.Generator()
                                         .manual_seed(len(g)))
        out[name] = (cfg, jsmoke(name), p,
                     jax.tree.map(jnp.asarray, bridge.to_numpy(p)))
    return out


@pytest.mark.parametrize("name,kind", [("qwen3-1.7b", "global"),
                                       ("gemma2-9b", "local"),
                                       ("gemma2-9b", "global")])
def test_gqa_forward_blocked_matches_reference(gqa_params, name, kind):
    cfg, jcfg, p, jp = gqa_params[name]
    x = _x(cfg, 2560, 11)
    want = jattn.gqa_forward(jp, jnp.asarray(x), jcfg, layer_kind=kind)
    got = attn.gqa_forward(p, torch.from_numpy(x), cfg, layer_kind=kind)
    _close(got, want)


def test_mla_forward_blocked_matches_reference():
    cfg = smoke_config("deepseek-v2-236b")
    p = attn.init_mla(5, "m", cfg, torch.float32, "cpu")
    x = _x(cfg, 2560, 12)
    want = jattn.mla_forward(jax.tree.map(jnp.asarray, bridge.to_numpy(p)),
                             jnp.asarray(x), jsmoke("deepseek-v2-236b"))
    _close(attn.mla_forward(p, torch.from_numpy(x), cfg), want)


@pytest.mark.parametrize("S", [2049, 3000])
def test_forward_entry_points_ragged_equal_unblocked(gqa_params, S,
                                                     monkeypatch):
    """``gqa_forward`` (gemma2 local and global) and ``mla_forward``
    above the threshold against the same calls with the threshold raised
    past S (the unblocked path)."""
    cfg, _, p, _ = gqa_params["gemma2-9b"]
    mcfg = smoke_config("deepseek-v2-236b")
    mp = attn.init_mla(5, "m", mcfg, torch.float32, "cpu")
    calls = [(attn.gqa_forward, p, cfg, dict(layer_kind="local")),
             (attn.gqa_forward, p, cfg, dict(layer_kind="global")),
             (attn.mla_forward, mp, mcfg, {})]
    xs = [torch.from_numpy(_x(c, S, S + i)) for i, (_, _, c, _) in
          enumerate(calls)]
    got = [fn(pp, x, c, **kw) for (fn, pp, c, kw), x in zip(calls, xs)]
    monkeypatch.setattr(attn, "BLOCKED_THRESHOLD", S)
    for (fn, pp, c, kw), x, g in zip(calls, xs, got):
        _close(g, fn(pp, x, c, **kw).numpy())


def test_reference_raises_at_ragged_s_and_port_answers(gqa_params):
    """The reference's ``blocked_attention`` asserts ``Sq % block_q == 0``
    (``block_q = min(512, Sq)``), so its ``gqa_forward`` (and ``forward``)
    raises at any S > 2048 that 512 does not divide; the port answers."""
    cfg, jcfg, p, jp = gqa_params["qwen3-1.7b"]
    x = _x(cfg, 2049, 13)
    with pytest.raises(AssertionError):
        jattn.gqa_forward(jp, jnp.asarray(x), jcfg)
    got = attn.gqa_forward(p, torch.from_numpy(x), cfg)
    assert got.shape == (1, 2049, cfg.d_model)
    assert bool(torch.isfinite(got).all())
