"""The port's f16 model steps against the reference's.

The reference serves f16 (``repro/models/common.py::dt`` maps "float16"),
and the port's chunked-prefill kernel takes f16 on its tensor-core body.
Here the ``qwen3-1.7b`` (GQA 2:1, qk-norm) and ``stablelm-1.6b`` (MHA)
smoke configs run with ``activation_dtype="float16"`` on both sides:
``prefill_step`` Sq 8, ``prefill_step`` Sq 3, then ``decode_step``
(``tests/test_torch_models.py::_step_inputs``: ragged positions and a
sentinel row), over a dense and a paged cache, with ``use_flash`` on and
off, from the reference's ``init_params`` with its fold keyed by
``zlib.crc32`` of the path (as that file's fixture does). Logits and the
whole updated cache after each step are held to ``|got - want| <= tol * (1
+ |want|)``.

Tolerances. Both sides round every layer's activations, K/V and P to f16
(2^-11 of the value) at the same places, but XLA and ATen sum the products
in other orders, so an f16 value may land one step apart, and the smoke
stacks carry that through the layers. Measured over 24 weight draws (keys
0-23, every case of the test), the worst reading of ``|got - want| / (1 +
|want|)`` was, for qwen3-1.7b, 4.7e-3 on the logits (max abs 5.1e-3 at
logits up to 3.9) and 1.1e-2 on the cache; for stablelm-1.6b 1.5e-2 on
the logits (max abs 1.7e-2) and 1.6e-2 on the cache. ``F16_TOL`` is about
3x each worst. A mask off by one key (each row also sees the next key, on
the flash path and the torch-op path alike) reads 0.75-1.68 on the logits
(key 0, every case), 37x or more over F16_TOL;
``test_f16_steps_catch_a_mask_fault`` requires 5x.
"""
import contextlib
import zlib

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
from repro_torch.kernels import ref
from repro_torch.models import attention
from repro_torch.models import transformer as tf

from test_torch_models import PS, SMAX, _page_table, _step_inputs

NAMES = ("qwen3-1.7b", "stablelm-1.6b")
#: (logits, cache) tolerance of |got - want| / (1 + |want|), per config
F16_TOL = {"qwen3-1.7b": (1.5e-2, 3.5e-2),
           "stablelm-1.6b": (4.5e-2, 5e-2)}


def _fold_by_crc(key, path: str):
    """The reference's ``_fold`` keyed by a stable hash of the path."""
    return jax.random.fold_in(key, np.uint32(zlib.crc32(path.encode())
                                             % (2 ** 31)))


def _excess(got, want):
    """max |got - want| / (1 + |want|), in f32."""
    g = bridge.to_numpy(got).astype(np.float32)
    w = np.asarray(want).astype(np.float32)
    return float((np.abs(g - w) / (1 + np.abs(w))).max())


@pytest.fixture(scope="module")
def f16_models():
    out = {}
    for name in NAMES:
        jcfg = jsmoke(name).replace(activation_dtype="float16")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jcommon, "_fold", _fold_by_crc)
            jp = jtf.init_params(jax.random.key(0), jcfg)
        out[name] = (jcfg, smoke_config(name).replace(
            activation_dtype="float16"), jp, bridge.params_from_numpy(
                jax.tree.map(np.asarray, jp), "cpu"))
    return out


@pytest.fixture(scope="module")
def f16_ref_steps(f16_models):
    """The reference's logits and caches after each step, per (config,
    paged): one run serves every case of both tests."""
    memo = {}

    def get(name, paged):
        if (name, paged) not in memo:
            jcfg, cfg, jp, _ = f16_models[name]
            if paged:
                jcache = jtf.init_paged_cache(jcfg, 16, PS)
                ctx = {"page_table": jnp.asarray(_page_table(16))}
            else:
                jcache, ctx = jtf.init_cache(jcfg, 3, SMAX), None
            out = [jax.tree.map(np.asarray, jcache)]
            for toks, pos in _step_inputs(cfg, paged):
                fn = jtf.decode_step if toks.shape[1] == 1 \
                    else jtf.prefill_step
                jl, jcache = fn(jp, jcfg, jnp.asarray(toks), jcache,
                                jnp.asarray(pos), ctx_extra=ctx)
                out.append((np.asarray(jl), jax.tree.map(np.asarray,
                                                         jcache)))
            memo[(name, paged)] = out
        return memo[(name, paged)]
    return get


def _port_readings(f16_models, f16_ref_steps, name, paged, flash):
    """The port's steps against the reference's: the worst logits and
    cache readings of ``_excess`` over the three steps."""
    _, cfg, _, tp = f16_models[name]
    init, *want = f16_ref_steps(name, paged)
    tcache = bridge.cache_from_numpy(init, "cpu")
    tctx = ({"page_table": torch.from_numpy(_page_table(16))}
            if paged else None)
    worst_l = worst_c = 0.0
    for (toks, pos), (jl, jcache) in zip(_step_inputs(cfg, paged), want):
        fn = tf.decode_step if toks.shape[1] == 1 else tf.prefill_step
        tl, tcache = fn(tp, cfg, torch.from_numpy(toks), tcache,
                        torch.from_numpy(pos), ctx_extra=tctx,
                        use_flash=flash)
        assert tl.dtype == torch.float16
        assert tl.shape == (3, 1, cfg.vocab_size)
        assert bool(torch.isfinite(tl).all())
        worst_l = max(worst_l, _excess(tl, jl))
        for s, leaves in tcache["layers"].items():
            for k, leaf in leaves.items():
                assert leaf.dtype == torch.float16, (s, k)
                worst_c = max(worst_c, _excess(leaf, jcache["layers"][s][k]))
    return worst_l, worst_c


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_f16_steps_match_reference(f16_models, f16_ref_steps, name, paged,
                                   flash):
    """prefill_step Sq=8, prefill_step Sq=3, decode_step in f16: logits
    and the whole updated cache after each call within F16_TOL of the
    reference's, dense or paged, flash or not."""
    got_l, got_c = _port_readings(f16_models, f16_ref_steps, name, paged,
                                  flash)
    tol_l, tol_c = F16_TOL[name]
    assert got_l <= tol_l, got_l
    assert got_c <= tol_c, got_c


@contextlib.contextmanager
def _mask_one_key_late():
    """Each query row also sees the key after its last one: on the flash
    path (the kernels' plain versions, which the CPU takes) and on the
    torch-op path."""
    def widen(valid):
        wide = valid.clone()
        wide[..., 1:] |= valid[..., :-1]
        return wide
    attend, split = ref._attend, attention._split_softmax
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref, "_attend",
                   lambda q, kr, vr, valid: attend(q, kr, vr, widen(valid)))
        mp.setattr(attention, "_split_softmax",
                   lambda s, mask, axes: split(s, widen(mask), axes))
        yield


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_f16_steps_catch_a_mask_fault(f16_models, f16_ref_steps, name,
                                      paged, flash):
    """The planted mask fault reads at least 5x over the logits'
    tolerance, so F16_TOL is not wide enough to hide a mask off by one."""
    with _mask_one_key_late():
        got_l, _ = _port_readings(f16_models, f16_ref_steps, name, paged,
                                  flash)
    assert got_l > 5 * F16_TOL[name][0], got_l
