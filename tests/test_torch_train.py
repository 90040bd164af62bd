"""The port's training stack (``repro_torch.train``, ``models.transformer.
loss_fn``, ``cfg.remat``) against the reference.

Twins of the reference's ``tests/test_train.py`` (AdamW on a quadratic,
data determinism, atomic checkpoints and bitwise resume, retention,
failure recovery, int8 error bound, error feedback; its resharded restore
onto a mesh waits on the port's sharding layer, so its twin takes the
unsharded case and records that ``shardings=`` raises), then the parity
tests. Model weights are the port's seeded ones, handed to the reference
through ``repro_torch.bridge``; batches are ``host_shard``'s, which both
packages compute with the same numpy code.

Tolerances, each about 5x the worst gap measured over six seeds of
weights and data (the spread of the two frameworks' f32 summation
orders):
- ``LOSS_TOL`` (rtol 1e-6, atol 1e-6 scaled by ``max(1, |want|)``) for
  ``loss_fn``'s loss and metrics: worst 2.2e-7 relative.
- ``GRAD_REL`` for each gradient leaf, as ``max|got - want|`` over
  ``max|want|``: qwen3 1e-5 (worst 1.5e-6), deepseek-v2 2e-4 (worst
  2.6e-5), moonshot 2e-3 (worst 3.7e-4: its MoE routes through gates whose
  derivatives amplify the rounding).
- ``TRAIN_TOL`` 1e-5 absolute on each of 5 trainer steps' losses: worst
  1.4e-6 (the gap grows step by step as the params drift apart).
"""
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro import train as jtrain
from repro.configs import smoke_config as jsmoke
from repro.models import transformer as jtf
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro_torch import bridge
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.models import transformer as tf
from repro_torch.train import (AdamWConfig, DataConfig, OptState, Trainer,
                               TrainerConfig, adamw_update, device_batch,
                               host_shard, init_opt_state)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.compression import (dequantize, ef_compress_tree,
                                           init_error_feedback,
                                           quantize_int8)
from repro_torch.train.tree import leaves, leaves_with_paths

LOSS_TOL = dict(rtol=1e-6, atol=1e-6)
GRAD_REL = {"qwen3-1.7b": 1e-5, "deepseek-v2-236b": 2e-4,
            "moonshot-v1-16b-a3b": 2e-3}
TRAIN_TOL = 1e-5
GRAD_NAMES = ("qwen3-1.7b", "moonshot-v1-16b-a3b", "deepseek-v2-236b")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Small shapes and many small ops: two intra-op threads, so that the
    suite's parallel workers do not oversubscribe the cores (with all of
    them, this file ran 20-35x slower beside five other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _j(tree):
    return jax.tree.map(jnp.asarray, bridge.to_numpy(tree))


# ---------------------------------------------------------------------------
# twins of tests/test_train.py
# ---------------------------------------------------------------------------

def test_adamw_minimizes_quadratic():
    cfg = AdamWConfig(lr=0.05, warmup_steps=1, total_steps=600,
                      weight_decay=0.0, clip_norm=10.0)
    params = {"w": torch.tensor([3.0, -2.0, 5.0])}
    state = init_opt_state(params)
    for _ in range(400):
        grads = {"w": 2 * params["w"]}
        params, state, m = adamw_update(cfg, grads, state, params)
    assert float(torch.max(torch.abs(params["w"]))) < 0.3


def test_data_determinism_and_sharding():
    dc = DataConfig(vocab_size=97, seq_len=16, global_batch=8)
    a = host_shard(dc, step=3)
    b = host_shard(dc, step=3)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = host_shard(dc, step=4)
    assert not np.array_equal(a["tokens"], c["tokens"])
    h0 = host_shard(dc, 3, host_id=0, num_hosts=2)
    assert h0["tokens"].shape == (4, 16)
    mult = 6364136223846793005 % 97
    frac = np.mean((a["tokens"] * mult + 12345) % 97 == a["labels"])
    assert frac > 0.9
    # the reference's batches, bit for bit (a verbatim copy)
    for mode in ("pattern", "random"):
        jdc = jtrain.DataConfig(vocab_size=97, seq_len=16, global_batch=8,
                                mode=mode, seed=4)
        pdc = DataConfig(vocab_size=97, seq_len=16, global_batch=8,
                         mode=mode, seed=4)
        for host in (0, 1):
            want = jtrain.host_shard(jdc, 5, host_id=host, num_hosts=2)
            got = host_shard(pdc, 5, host_id=host, num_hosts=2)
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(got[k], want[k])


def test_checkpoint_atomic_and_resume_bitwise():
    with tempfile.TemporaryDirectory() as d:
        tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                "b": {"c": torch.tensor(7, dtype=torch.int32)}}
        ckpt.save(d, 10, tree, meta={"next_step": 10})
        ckpt.save(d, 20, tree, meta={"next_step": 20})
        assert ckpt.latest_step(d) == 20
        like = {"a": torch.zeros(2, 3), "b": {"c": torch.zeros(
            (), dtype=torch.int32)}}
        got, manifest = ckpt.restore(d, 20, like)
        assert torch.equal(got["a"], tree["a"])
        assert torch.equal(got["b"]["c"], tree["b"]["c"])
        assert manifest["meta"]["next_step"] == 20
        assert not [f for f in os.listdir(d) if f.endswith(".tmp")]


def test_checkpoint_retention():
    with tempfile.TemporaryDirectory() as d:
        for s in (1, 2, 3, 4, 5):
            ckpt.save(d, s, {"x": torch.zeros(1)}, keep=2)
        steps = sorted(os.listdir(d))
        assert len(steps) == 2 and steps[-1].endswith("0000000005")


def test_trainer_failure_recovery_identical_loss():
    """Kill-and-restart: a trainer resumed from the checkpoint reproduces
    the uninterrupted run's losses exactly."""
    cfg = smoke_config("stablelm-1.6b").replace(num_layers=1)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    oc = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=12)
    t1 = Trainer(cfg, dc, oc, TrainerConfig(steps=12), seed=5, device="cpu")
    h_full = t1.run()
    with tempfile.TemporaryDirectory() as d2:
        t2 = Trainer(cfg, dc, oc,
                     TrainerConfig(steps=6, ckpt_dir=d2, ckpt_every=6),
                     seed=5, device="cpu")
        t2.run()
        t3 = Trainer(cfg, dc, oc,
                     TrainerConfig(steps=12, ckpt_dir=d2, ckpt_every=6),
                     seed=5, device="cpu")
        assert t3.step == 6
        h_resumed = t3.run()
    assert [h["loss"] for h in h_full[6:]] == [h["loss"] for h in h_resumed]


def test_checkpoint_restore_unsharded_and_shardings_waits():
    """The reference's resharding test on a 1-device mesh is the
    unsharded restore; a restore onto a mesh (``shardings=``) raises."""
    with tempfile.TemporaryDirectory() as d:
        tree = {"w": torch.arange(8, dtype=torch.float32)}
        ckpt.save(d, 1, tree)
        got, _ = ckpt.restore(d, 1, {"w": torch.zeros(8)})
        assert torch.equal(got["w"], tree["w"])
        with pytest.raises(NotImplementedError, match="queue 1 item 5"):
            ckpt.restore(d, 1, {"w": torch.zeros(8)}, shardings={"w": 0})
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        Trainer(smoke_config("qwen3-1.7b"), DataConfig(512, 8, 2),
                AdamWConfig(), TrainerConfig(), mesh=object(), device="cpu")


@given(seed=st.integers(0, 100))
@settings(max_examples=10, deadline=None)
def test_quantize_int8_bounded_error(seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32) * 10)
    q, s = quantize_int8(x)
    assert q.dtype == torch.int8
    err = (dequantize(q, s) - x).abs().numpy()
    assert err.max() <= float(s) * 0.5 + 1e-6


def test_error_feedback_accumulates_residual():
    g = {"w": torch.full((32,), 0.00123) + torch.linspace(0, 1e-4, 32)}
    err = init_error_feedback(g)
    total = torch.zeros(32)
    n = 50
    for _ in range(n):
        deq, err = ef_compress_tree(g, err)
        total = total + deq["w"]
    np.testing.assert_allclose((total / n).numpy(), g["w"].numpy(),
                               rtol=0.02, atol=1e-6)


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------

def _batch(cfg, seed=0, B=4, S=16):
    return host_shard(DataConfig(cfg.vocab_size, S, B, seed=seed), 0)


def _port_grads(p, cfg, batch):
    flat = leaves(p)
    for x in flat:
        x.requires_grad_(True)
    loss, metrics = tf.loss_fn(p, cfg, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
    grads = torch.autograd.grad(loss, flat, materialize_grads=True)
    for x in flat:
        x.requires_grad_(False)
    return {k: v.detach() for k, v in metrics.items()}, grads


@pytest.fixture(scope="module")
def grad_cases():
    """Per config: the port's params, batch, metrics and grads, and the
    reference's ``jax.value_and_grad`` of its ``loss_fn`` on them."""
    out = {}
    for name in GRAD_NAMES:
        cfg, jcfg = smoke_config(name), jsmoke(name)
        p = tf.init_params(cfg, 1, "cpu")
        b = _batch(cfg)
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        (_, jm), jg = jax.value_and_grad(
            lambda q: jtf.loss_fn(q, jcfg, jb), has_aux=True)(_j(p))
        m, g = _port_grads(p, cfg, b)
        out[name] = (cfg, p, b, m, g, jm, jg)
    return out


@pytest.mark.parametrize("name", GRAD_NAMES)
def test_loss_fn_matches_reference(grad_cases, name):
    cfg, _, _, m, _, jm, _ = grad_cases[name]
    assert set(m) == set(jm)
    want_keys = {"loss", "nll"} | ({"z_loss", "lb_loss", "dropped_frac"}
                                   if cfg.moe else set())
    assert set(m) == want_keys
    for k in m:
        want = float(jm[k])
        np.testing.assert_allclose(float(m[k]), want, rtol=LOSS_TOL["rtol"],
                                   atol=LOSS_TOL["atol"] * max(1, abs(want)))
    if cfg.moe:
        assert float(m["dropped_frac"]) == float(jm["dropped_frac"])
        assert float(m["z_loss"]) > 0 and float(m["lb_loss"]) > 0


@pytest.mark.parametrize("name", GRAD_NAMES)
def test_loss_grads_match_reference(grad_cases, name):
    _, p, _, _, g, _, jg = grad_cases[name]
    jflat = jax.tree_util.tree_flatten_with_path(jg)[0]
    paths = [path for path, _ in leaves_with_paths(p)]
    assert len(paths) == len(jflat) == len(g)
    for path, got, (jpath, want) in zip(paths, g, jflat):
        assert "/".join(path) == "/".join(
            str(getattr(k, "key", getattr(k, "idx", k))) for k in jpath)
        want = np.asarray(want)
        gap = np.abs(got.numpy() - want).max()
        assert gap <= GRAD_REL[name] * np.abs(want).max(), (path, gap)


def _adam_case(seed):
    rng = np.random.default_rng(seed)
    mk = lambda s: rng.standard_normal(s).astype(np.float32)
    params = {"w": mk((6, 5)), "b": mk((5,)), "l": [mk((3, 4))]}
    grads = {"w": mk((6, 5)), "b": mk((5,)), "l": [mk((3, 4))]}
    m = {"w": mk((6, 5)) * 0.1, "b": mk((5,)) * 0.1, "l": [mk((3, 4)) * 0.1]}
    v = {"w": np.abs(mk((6, 5))) * 0.01, "b": np.abs(mk((5,))) * 0.01,
         "l": [np.abs(mk((3, 4))) * 0.01]}
    return params, grads, m, v


@pytest.mark.parametrize("count", [3, 40])
def test_adamw_update_matches_reference(count):
    """One update before (count 3 -> 4 of warmup 10) and after warmup,
    with clipping in force (clip_norm below the grads' norm)."""
    params, grads, m, v = _adam_case(count)
    cfg = AdamWConfig(lr=1e-2, warmup_steps=10, total_steps=100,
                      clip_norm=2.0)
    jcfg = jopt.AdamWConfig(lr=1e-2, warmup_steps=10, total_steps=100,
                            clip_norm=2.0)
    t = bridge.params_from_numpy
    state = OptState(t(m, "cpu"), t(v, "cpu"),
                     torch.tensor(count, dtype=torch.int32))
    jstate = jopt.OptState(_j(t(m, "cpu")), _j(t(v, "cpu")),
                           jnp.asarray(count, jnp.int32))
    got = adamw_update(cfg, t(grads, "cpu"), state, t(params, "cpu"))
    want = jopt.adamw_update(jcfg, _j(t(grads, "cpu")), jstate,
                             _j(t(params, "cpu")))
    for a, b in zip(leaves([got[0], got[1].m, got[1].v]),
                    jax.tree.leaves([want[0], want[1].m, want[1].v])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6,
                                   atol=1e-7)
    assert int(got[1].count) == int(want[1].count) == count + 1
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(got[2][k]), float(want[2][k]),
                                   rtol=1e-6)
    # donated: the same values, written into the tensors given
    p_in, st_in = t(params, "cpu"), OptState(t(m, "cpu"), t(v, "cpu"),
                                             state.count)
    don = adamw_update(cfg, t(grads, "cpu"), st_in, p_in, donate=True)
    assert don[0]["w"] is p_in["w"]
    for a, b in zip(leaves([don[0], don[1].m, don[1].v]),
                    leaves([got[0], got[1].m, got[1].v])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["qwen3-1.7b", "moonshot-v1-16b-a3b",
                                  "zamba2-1.2b"])
def test_remat_equal_loss_and_grads(name, monkeypatch):
    """``remat`` none, full and dots: the same loss, metrics and grads bit
    for bit (a recomputation runs the same ops on the same values); under
    no grad every setting is ``forward`` itself. Each period of a remat
    run goes through ``torch.utils.checkpoint``."""
    import torch.utils.checkpoint as tuc
    cfg0 = smoke_config(name)
    p = tf.init_params(cfg0, 2, "cpu")
    b = _batch(cfg0, seed=2)
    calls = []
    real = tuc.checkpoint
    monkeypatch.setattr(tuc, "checkpoint",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    n_periods = tf._pattern_segments(cfg0)[3]
    res = {}
    for remat in ("none", "full", "dots"):
        cfg = cfg0.replace(remat=remat)
        calls.clear()
        res[remat] = _port_grads(p, cfg, b)
        assert len(calls) == (0 if remat == "none" else n_periods)
        assert all(("context_fn" in kw) == (remat == "dots") for kw in calls)
        with torch.no_grad():
            logits, _ = tf.forward(p, cfg, {"tokens": torch.from_numpy(
                b["tokens"])})
        res[remat] += (logits,)
    m0, g0, l0 = res["none"]
    for remat in ("full", "dots"):
        m, g, lg = res[remat]
        assert torch.equal(lg, l0)
        for k in m0:
            assert torch.equal(m[k], m0[k]), (remat, k)
        for a, b_ in zip(g, g0):
            assert torch.equal(a, b_), remat


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_every_family_trains(name):
    """Autograd through every family's ``forward`` (MoE dispatch, MLA,
    SSM scans, the hybrid's shared block, the encoder, the VLM's cross
    layers): three trainer steps with finite losses and params, every
    param leaf moved but at most one (whisper's ungated cross gate, which
    the loss does not reach: a zero gradient, as in JAX)."""
    cfg = smoke_config(name)
    dc = DataConfig(cfg.vocab_size, 8, 2, seed=4)
    tr = Trainer(cfg, dc, AdamWConfig(lr=1e-3, warmup_steps=1,
                                      total_steps=3),
                 TrainerConfig(steps=3), seed=4, device="cpu")
    before = [p.clone() for p in leaves(tr.params)]
    losses = [h["loss"] for h in tr.run()]
    assert len(losses) == 3 and all(np.isfinite(losses))
    moved = [not torch.equal(a, b) for a, b in zip(before,
                                                    leaves(tr.params))]
    assert sum(moved) >= len(moved) - 1, name
    assert all(bool(torch.isfinite(p).all()) for p in leaves(tr.params))


def _state_tree():
    g = torch.Generator().manual_seed(3)
    r = lambda *s: torch.randn(s, generator=g)
    params = {"embed": r(5, 4), "prefix": [{"w": r(4, 4)}, {"w": r(4, 2)}],
              "layers": {"s0": {"ln": r(2, 4), "attn": {"wq": r(2, 4, 3)}}}}
    opt = OptState({k: v for k, v in params.items()},
                   {k: v for k, v in params.items()},
                   torch.tensor(9, dtype=torch.int32))
    return {"params": params, "opt": opt._asdict(),
            "err": {"embed": r(5, 4), "prefix": [{"w": r(4, 4)},
                                                 {"w": r(4, 2)}],
                    "layers": {"s0": {"ln": r(2, 4),
                                      "attn": {"wq": r(2, 4, 3)}}}}}


def test_checkpoints_cross_between_packages():
    """A port checkpoint restores in the reference's ``restore`` and a
    reference checkpoint in the port's, leaf for leaf; both write the
    same array names and manifest."""
    tree = _state_tree()
    np_tree = jax.tree.map(np.asarray, bridge.to_numpy(tree))
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(os.path.join(d, "port"), 4, tree, meta={"next_step": 4})
        jckpt.save(os.path.join(d, "ref"), 4, np_tree,
                   meta={"next_step": 4})
        jgot, jman = jckpt.restore(os.path.join(d, "port"), 4,
                                   jax.tree.map(jnp.zeros_like, np_tree))
        got, man = ckpt.restore(os.path.join(d, "ref"), 4,
                                bridge.to_numpy(tree))
        for (path, a), b, c in zip(leaves_with_paths(tree),
                                   jax.tree.leaves(jgot), leaves(got)):
            np.testing.assert_array_equal(np.asarray(b), a.numpy())
            np.testing.assert_array_equal(c.numpy(), a.numpy())
        assert man == jman
        for sub in ("port", "ref"):
            arrays = np.load(os.path.join(d, sub, "step_0000000004",
                                          "arrays.npz"))
            assert sorted(arrays.files) == sorted(
                "|".join(p) for p, _ in leaves_with_paths(tree))
        assert "opt|count" in arrays.files


def test_bf16_leaf_round_trips():
    """A bf16 leaf is written as its f32 value and comes back bf16, bit
    for bit; a reference checkpoint's bf16 leaf (``ml_dtypes`` bits) is
    read as bf16 bits."""
    t = torch.randn(7, generator=torch.Generator().manual_seed(1)).to(
        torch.bfloat16)
    like = {"x": torch.zeros(7, dtype=torch.bfloat16)}
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 1, {"x": t})
        got, man = ckpt.restore(d, 1, like)
        jckpt.save(d, 2, {"x": jnp.asarray(bridge.to_numpy(t),
                                           jnp.bfloat16)})
        ref, _ = ckpt.restore(d, 2, like)
    assert man["leaves"]["x"]["dtype"] == "float32"
    assert got["x"].dtype == torch.bfloat16 and torch.equal(got["x"], t)
    assert ref["x"].dtype == torch.bfloat16 and torch.equal(ref["x"], t)


def test_device_batch_extra_fields():
    """The encoder's frames and the VLM's image features are drawn from a
    generator seeded by (seed, step); tokens are ``host_shard``'s."""
    from repro_torch.models import io
    cfg = smoke_config("llama-3.2-vision-90b")
    dc = DataConfig(cfg.vocab_size, 8, 2, seed=3)
    extra = [f for f in io.batch_fields(cfg, 2, 8) if f[0] == "vision"]
    a = device_batch(dc, 4, extra, "cpu")
    b = device_batch(dc, 4, extra, "cpu")
    c = device_batch(dc, 5, extra, "cpu")
    assert torch.equal(a["vision"], b["vision"])
    assert not torch.equal(a["vision"], c["vision"])
    assert a["vision"].shape == extra[0][1]
    np.testing.assert_array_equal(a["tokens"].numpy(),
                                  host_shard(dc, 4)["tokens"])


def test_trainer_steps_match_reference():
    """5 steps of the qwen3 smoke config from the same initial params
    (the port's, handed to the reference trainer) on the same batches."""
    cfg, jcfg = smoke_config("qwen3-1.7b"), jsmoke("qwen3-1.7b")
    dc = DataConfig(cfg.vocab_size, 16, 4, seed=1)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    tr = Trainer(cfg, dc, AdamWConfig(**kw), TrainerConfig(steps=5), seed=1,
                 device="cpu")
    jt = jtrain.Trainer(jcfg, jtrain.DataConfig(cfg.vocab_size, 16, 4,
                                                seed=1),
                        jtrain.AdamWConfig(**kw),
                        jtrain.TrainerConfig(steps=5))
    jt.params = _j(tr.params)
    want = [h["loss"] for h in jt.run()]
    got = [h["loss"] for h in tr.run()]
    assert len(got) == 5
    np.testing.assert_allclose(got, want, rtol=0, atol=TRAIN_TOL)
    assert got[-1] < got[0]
