"""The port's sharding layer (``repro_torch.dist.sharding``,
``launch.specs``' cache rule, ``train.optimizer.zero1_pspecs``) against the
reference's.

Twins of ``tests/test_sharding.py``, then parity: the port's specs equal
the reference's, leaf for leaf, for every config of ``ARCHS`` at full width
on the production meshes (16x16 and 2x16x16), params under both attention
fallbacks, caches (``decode_32k``) and ZeRO-1 moments. The port's side is
its meta tree (``init_params``/``init_cache`` on ``device="meta"``) on a
fake process group of 256 or 512 ranks in this process; the reference's is
``jax.eval_shape`` on an ``AbstractMesh``. Every process group a test
starts is destroyed before it ends.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as jget
from repro.dist import sharding as jsh
from repro.launch import specs as jspecs
from repro.models import transformer as jtf
from repro.train import optimizer as jopt
from repro_torch.configs import ARCHS, SHAPES, get_config, smoke_config
from repro_torch.dist.sharding import (_path_str, hint, param_pspecs,
                                       partition_dims, set_attn_fallback,
                                       use_mesh)
from repro_torch.launch.mesh import fake_group, make_mesh
from repro_torch.launch.specs import cache_pspecs
from repro_torch.models import transformer as tf
from repro_torch.train.optimizer import zero1_pspecs
from repro_torch.train.tree import leaves, leaves_with_paths

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
DECODE = SHAPES["decode_32k"]


@pytest.fixture
def mesh11():
    """A 1x1 (data, model) mesh on a fake group of one rank."""
    with fake_group(1):
        yield make_mesh((1, 1), ("data", "model"))


@pytest.fixture
def fallback():
    yield
    set_attn_fallback("headdim")
    jsh.set_attn_fallback("headdim")


# ---------------------------------------------------------------------------
# twins of tests/test_sharding.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(ARCHS))
def test_param_pspecs_divisible_on_production_axis(name, mesh11):
    """The full config's meta params get one spec a leaf on a 1x1 mesh,
    every spec as long as its leaf's rank, every sharded dim divisible."""
    params = tf.init_params(get_config(name), 0, "meta")
    specs = param_pspecs(params, mesh11)
    flat_p, flat_s = leaves(params), leaves(specs)
    assert len(flat_p) == len(flat_s)
    for leaf, sh in zip(flat_p, flat_s):
        assert len(sh.spec) == leaf.dim()
        for dim, ax in zip(leaf.shape, sh.spec):
            if ax is not None:
                assert dim % mesh11.shape[ax] == 0


def test_param_pspecs_prod_mesh_divisibility(mesh11):
    params = tf.init_params(get_config("qwen3-1.7b"), 0, "meta")
    specs = param_pspecs(params, mesh11)
    assert specs["embed"].spec[0] in ("model", None)


def _named_leaves(cfg):
    params = tf.init_params(cfg, 0, "meta")
    return [(_path_str(p), tuple(leaf.shape))
            for p, leaf in leaves_with_paths(params)]


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_partition_dims_rules_on_production_sizes(name):
    """The reference's rule checks at model=16, expert=8 on the port's
    leaf paths and shapes."""
    cfg = get_config(name)
    mesh = {"model": 16, "expert": 8}
    for pname, shape in _named_leaves(cfg):
        dims = partition_dims(pname, shape, model=16, expert=8)
        assert len(dims) == len(shape)
        for d, ax in zip(shape, dims):
            if ax is not None:
                assert d % mesh[ax] == 0 and d >= mesh[ax], (pname, shape)
        nd = len(shape)
        if len(shape) < 2:
            assert dims == (None,) * nd
            continue
        if "experts" in pname.split("/"):
            e = nd - 3
            assert dims[e] in ("expert", None), (pname, dims)
            assert "expert" not in dims[:e] + dims[e + 1:], (pname, dims)
            assert "model" not in dims[:e + 1], (pname, dims)
        leaf = pname.rsplit("/", 1)[-1]
        if leaf in ("wq_a", "wkv_a"):
            assert dims[-1] is None, (pname, dims)
        if leaf in ("wq_b", "wk_b", "wv_b") and nd >= 3:
            assert dims[nd - 3] is None, (pname, dims)
            if shape[nd - 2] % 16 == 0 and shape[nd - 2] >= 16:
                assert dims[nd - 2] == "model", (pname, dims)


def test_partition_dims_expert_axis_absent_replicates_expert_dim():
    dims = partition_dims("layers/moe/experts/w_gate", (4, 60, 512, 256),
                          model=16, expert=1)
    assert dims == (None, None, "model", None)


def test_partition_dims_attn_replicate_fallback():
    dims = partition_dims("layers/attn/wq_b", (1536, 128, 192),
                          model=16, attn_fallback="replicate")
    assert dims == (None, "model", None)
    dims = partition_dims("layers/attn/wq_b", (1536, 12, 192),
                          model=16, attn_fallback="replicate")
    assert dims == (None, None, None)


def test_param_pspecs_uses_expert_axis_when_mesh_has_one(mesh11):
    """On a 1x1 data/model mesh everything replicates."""
    params = tf.init_params(smoke_config("deepseek-v2-236b"), 0, "meta")
    specs = param_pspecs(params, mesh11)
    for leaf, sh in zip(leaves(params), leaves(specs)):
        assert sh.spec == (None,) * leaf.dim()
        assert all(p.is_replicate() for p in sh.placements)


def test_hint_noop_outside_mesh():
    x = torch.ones(4, 4)
    assert hint(x, "data", None) is x


def test_hint_inside_mesh_jit(mesh11):
    """Inside a 1x1 mesh a hint is a redistribute that keeps the values."""
    with use_mesh(mesh11):
        out = hint(torch.ones(4, 4) * 2, "data", "model")
    assert torch.equal(out.full_tensor(), 2 * torch.ones(4, 4))


@pytest.mark.parametrize("name", ["qwen3-1.7b", "deepseek-v2-236b",
                                  "rwkv6-7b", "zamba2-1.2b"])
def test_cache_specs_build(name, mesh11):
    cache = tf.init_cache(smoke_config(name), 4, 64, device="meta")
    specs = cache_pspecs(cache, mesh11)
    assert [p for p, _ in leaves_with_paths(specs)] == \
        [p for p, _ in leaves_with_paths(cache)]


# ---------------------------------------------------------------------------
# parity with the reference at full width
# ---------------------------------------------------------------------------

_TREES = {}


def _trees(name):
    """(port meta params, reference abstract params, port meta decode
    cache, reference abstract decode cache), built once a config."""
    if name not in _TREES:
        cfg, jcfg = get_config(name), jget(name)
        B, S = DECODE.global_batch, DECODE.seq_len
        _TREES[name] = (
            tf.init_params(cfg, 0, "meta"),
            jax.eval_shape(lambda k: jtf.init_params(k, jcfg),
                           jax.random.key(0)),
            tf.init_cache(cfg, B, S, device="meta"),
            jax.eval_shape(lambda: jtf.init_cache(jcfg, B, S)))
    return _TREES[name]


def _jspecs(tree):
    return [(_path_str(p), tuple(s.spec)) for p, s in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: hasattr(x, "spec"))[0]]


def _pspecs(tree):
    return [(_path_str(p), s.spec) for p, s in leaves_with_paths(tree)]


@pytest.mark.parametrize("attn", ["headdim", "replicate"])
@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_param_specs_match_reference(name, mesh_kind, attn, fallback):
    params, jparams, _, _ = _trees(name)
    dims, axes = MESHES[mesh_kind]
    set_attn_fallback(attn)
    jsh.set_attn_fallback(attn)
    want = _jspecs(jsh.param_pspecs(jparams, AbstractMesh(dims, axes)))
    with fake_group(int(np.prod(dims))):
        mesh = make_mesh(dims, axes)
        specs = param_pspecs(params, mesh)
        got = _pspecs(specs)
        # placements: Shard(d) on each mesh dim the spec names
        for (_, leaf), sh in zip(leaves_with_paths(params), leaves(specs)):
            for ax, pl in zip(axes, sh.placements):
                d = [i for i, s in enumerate(sh.spec) if s == ax]
                assert (pl.is_shard(d[0]) if d else pl.is_replicate())
    assert got == want
    assert any(s != (None,) * len(s) for _, s in got)


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_cache_and_zero1_specs_match_reference(name, mesh_kind):
    params, jparams, cache, jcache = _trees(name)
    dims, axes = MESHES[mesh_kind]
    jmesh = AbstractMesh(dims, axes)
    want_cache = _jspecs(jspecs.cache_pspecs(jcache, jmesh))
    jz = jopt.zero1_pspecs(jparams, jmesh)
    with fake_group(int(np.prod(dims))):
        mesh = make_mesh(dims, axes)
        got_cache = _pspecs(cache_pspecs(cache, mesh))
        z = zero1_pspecs(params, mesh)
        got_m, got_v, count = _pspecs(z.m), _pspecs(z.v), z.count.spec
        off = zero1_pspecs(params, mesh, enabled=False)
        assert _pspecs(off.m) == _pspecs(param_pspecs(params, mesh))
    assert got_cache == want_cache
    assert got_m == _jspecs(jz.m) and got_v == _jspecs(jz.v)
    assert count == tuple(jz.count.spec) == ()
    assert any("data" in s for _, s in got_m)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_meta_params_match_real_and_reference(name):
    """``init_params`` on meta: the real tree's paths, shapes and dtypes at
    smoke size (and its cache's), the reference's abstract tree at full
    width."""
    small = smoke_config(name)
    real = leaves_with_paths(tf.init_params(small, 0, "cpu"))
    meta = leaves_with_paths(tf.init_params(small, 0, "meta"))
    assert [(p, a.shape, a.dtype) for p, a in real] == \
        [(p, a.shape, a.dtype) for p, a in meta]
    assert all(a.device.type == "meta" for _, a in meta)
    real_c = leaves_with_paths(tf.init_cache(small, 2, 16, device="cpu"))
    meta_c = leaves_with_paths(tf.init_cache(small, 2, 16, device="meta"))
    assert [(p, a.shape, a.dtype) for p, a in real_c] == \
        [(p, a.shape, a.dtype) for p, a in meta_c]
    params, jparams, _, _ = _trees(name)
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert [(_path_str(p), tuple(a.shape), str(a.dtype).split(".")[-1])
            for p, a in leaves_with_paths(params)] == \
        [(_path_str(p), tuple(a.shape), str(a.dtype)) for p, a in jflat]


def test_hint_redistributes_inside_mesh():
    """On a (data=2, model=4) fake mesh a hint places a DTensor by its
    axes; a dim that does not divide, or an axis the mesh lacks,
    replicates."""
    from torch.distributed.tensor import Replicate, Shard
    with fake_group(8):
        mesh = make_mesh((2, 4), ("data", "model"))
        with use_mesh(mesh):
            x = torch.empty(8, 6, 16, device="meta")
            y = hint(x, "data", None, "model")
            assert tuple(y.placements) == (Shard(0), Shard(2))
            assert tuple(y.to_local().shape) == (4, 6, 4)
            z = hint(y, "data", "model", "expert")      # 6 % 4 != 0
            assert tuple(z.placements) == (Shard(0), Replicate())
        assert hint(x, "data") is x                      # outside the mesh
