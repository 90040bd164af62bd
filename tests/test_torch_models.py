"""The port's model against the reference on the same weights and inputs.

``rms_norm`` and ``apply_rope``, then ``decode_step`` / ``prefill_step``
logits and updated caches for the ``stablelm-1.6b`` (MHA) and ``qwen3-1.7b``
(GQA 2:1, qk-norm, tied embeddings) smoke configs in f32, over dense and
paged caches, Sq in {8, 3, 1}, ragged per-row positions and a sentinel row,
with ``use_flash`` on and off. Weights and caches go from the reference to
the port through ``repro_torch.bridge``.

Tolerance 1e-4 (atol and rtol): both sides compute in f32, but XLA and
ATen sum the matrix products and the softmax in other orders, which moves
the last few bits of every layer's output; 1e-4 leaves two orders of
magnitude over what two layers of that drift give, and a wrong mask, rope
or cache write gives errors of order one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.models import common as jcommon
from repro.models import transformer as jtf
from repro_torch import bridge
from repro_torch.configs import smoke_config
from repro_torch.models import common, transformer as tf

TOL = dict(rtol=1e-4, atol=1e-4)
SMAX, PS, P = 24, 4, 6          # dense window; paged: page size, pages/row


@pytest.fixture(scope="module")
def models():
    out = {}
    for name in ("stablelm-1.6b", "qwen3-1.7b"):
        jcfg = jsmoke(name)
        jp = jtf.init_params(jax.random.key(0), jcfg)
        out[name] = (jcfg, smoke_config(name), jp,
                     bridge.params_from_numpy(jax.tree.map(np.asarray, jp),
                                              "cpu"))
    return out


def _close(got, want):
    np.testing.assert_allclose(bridge.to_numpy(got), np.asarray(want), **TOL)


def _caches_close(tcache, jcache):
    jt = jax.tree.map(np.asarray, jcache)     # a no-op on numpy leaves
    for s, leaves in tcache["layers"].items():
        for k, leaf in leaves.items():
            _close(leaf, jt["layers"][s][k])


@pytest.mark.parametrize("shape", [(2, 5, 32), (3, 4, 2, 64)])
def test_rms_norm(shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32) * 3
    g = rng.standard_normal(shape[-1:]).astype(np.float32)
    want = jcommon.rms_norm(jnp.asarray(x), jnp.asarray(g), 1e-6)
    got = common.rms_norm(torch.from_numpy(x), torch.from_numpy(g), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 4, 32)).astype(np.float32)
    pos = np.asarray([[0, 1, 2, 3, 4, 5], [100, 101, 102, 500, 999, 7]],
                     np.int32)
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _page_table(n_pages):
    """Distinct pages for rows 0-1; row 2 is a free slot (all unmapped)."""
    pt = np.full((3, P), n_pages, np.int32)
    pt[0] = [3, 7, 1, 12, 0, 9]
    pt[1] = [2, 15, 4, 6, 11, 5]
    return pt


def _step_inputs(cfg, paged, n_pages=16):
    """(cache kind setup, steps): prefill Sq=8, prefill Sq=3, decode, with
    row 2 at the write sentinel (a masked row of the engine's batched
    calls: it writes nothing)."""
    rng = np.random.default_rng(5)
    sentinel = P * PS if paged else SMAX
    steps = []
    for Sq, pos in ((8, [0, 5, sentinel]), (3, [8, 13, sentinel]),
                    (1, [11, 16, sentinel])):
        toks = rng.integers(0, cfg.vocab_size, (3, Sq)).astype(np.int32)
        steps.append((toks, np.asarray(pos, np.int32)))
    return steps


@pytest.fixture(scope="module")
def ref_steps(models):
    """Reference logits and caches after each step, per (config, paged),
    through the reference's einsum attention core. (Its flash kernels agree
    with that core to 2e-5, which tests/test_kernels.py asserts, so one
    reference run serves the port's flash and torch-op paths alike.)"""
    memo = {}

    def get(name, paged):
        if (name, paged) in memo:
            return memo[(name, paged)]
        jcfg, cfg, jp, _ = models[name]
        if paged:
            jcache = jtf.init_paged_cache(jcfg, 16, PS)
            ctx = {"page_table": jnp.asarray(_page_table(16))}
        else:
            jcache, ctx = jtf.init_cache(jcfg, 3, SMAX), None
        out = [jax.tree.map(np.asarray, jcache)]
        for toks, pos in _step_inputs(cfg, paged):
            fn = jtf.decode_step if toks.shape[1] == 1 else jtf.prefill_step
            jl, jcache = fn(jp, jcfg, jnp.asarray(toks), jcache,
                            jnp.asarray(pos), ctx_extra=ctx)
            out.append((np.asarray(jl), jax.tree.map(np.asarray, jcache)))
        memo[(name, paged)] = out
        return out
    return get


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("name", ["stablelm-1.6b", "qwen3-1.7b"])
def test_steps_match_reference(models, ref_steps, name, paged, flash):
    """prefill_step Sq=8, prefill_step Sq=3, decode_step: logits and the
    whole updated cache after each call, dense or paged, flash or not."""
    _, cfg, _, tp = models[name]
    init, *want = ref_steps(name, paged)
    tcache = bridge.cache_from_numpy(init, "cpu")
    tctx = ({"page_table": torch.from_numpy(_page_table(16))}
            if paged else None)
    for (toks, pos), (jl, jcache) in zip(_step_inputs(cfg, paged), want):
        fn = tf.decode_step if toks.shape[1] == 1 else tf.prefill_step
        tl, tcache = fn(tp, cfg, torch.from_numpy(toks), tcache,
                        torch.from_numpy(pos), ctx_extra=tctx,
                        use_flash=flash)
        assert tl.shape == (3, 1, cfg.vocab_size)
        assert bool(torch.isfinite(tl).all())
        _close(tl, jl)
        _caches_close(tcache, jcache)


@pytest.mark.parametrize("pos", [5, SMAX])
def test_decode_scalar_pos_write(models, pos):
    """A scalar ``pos`` takes the guarded one-token write: in range it
    writes every row at ``pos``, at ``pos >= Smax`` nothing."""
    jcfg, cfg, jp, tp = models["qwen3-1.7b"]
    rng = np.random.default_rng(9)
    jcache = jtf.init_cache(jcfg, 2, SMAX)
    jcache = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype), jcache)
    tcache = bridge.cache_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    toks = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    jl, jcache = jtf.decode_step(jp, jcfg, jnp.asarray(toks), jcache,
                                 jnp.asarray(pos, jnp.int32))
    tl, tcache = tf.decode_step(tp, cfg, torch.from_numpy(toks), tcache,
                                torch.tensor(pos, dtype=torch.int32))
    _close(tl, jl)
    _caches_close(tcache, jcache)


def test_forward_matches_reference(models):
    jcfg, cfg, jp, tp = models["qwen3-1.7b"]
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 7))
    jl, _ = jtf.forward(jp, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, aux = tf.forward(tp, cfg, {"tokens": torch.from_numpy(toks)})
    assert aux == {}
    _close(tl, jl)


def test_unported_families_raise():
    with pytest.raises(NotImplementedError):
        tf.init_params(smoke_config("deepseek-v2-236b"), 0, "cpu")
    with pytest.raises(NotImplementedError):
        tf.init_cache(smoke_config("rwkv6-7b"), 1, 8, device="cpu")
