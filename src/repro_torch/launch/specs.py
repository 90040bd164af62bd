"""Abstract input/cache/state specs + shardings for the dry run
(``repro.launch.specs`` in PyTorch).

Everything here is on the meta device: no memory is ever allocated. The
counterpart of a ``jax.ShapeDtypeStruct`` is an empty meta tensor, that of
a ``NamedSharding`` a :class:`~repro_torch.dist.sharding.PSpec`.
``batch_pspec`` and ``cache_pspecs`` are the reference's rules, verbatim.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..dist.sharding import PSpec, batch_axes, param_pspecs
from ..models import io as model_io
from ..models import transformer as tf
from ..train.optimizer import AdamWConfig, OptState, zero1_pspecs
from ..train.tree import leaves_with_paths, unflatten


def _axes_ok(mesh, axes, dim):
    n = int(np.prod([mesh.shape[a] for a in axes]))
    return dim % n == 0 and dim >= n


def batch_pspec(mesh, dim):
    ax = batch_axes(mesh)
    if ax and _axes_ok(mesh, ax, dim):
        return ax if len(ax) > 1 else ax[0]
    return None


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                mode: str) -> Dict:
    """Meta stand-ins + PSpecs for every model input."""
    B = shape.global_batch
    if mode in ("train", "prefill"):
        structs = model_io.abstract_batch(cfg, B, shape.seq_len,
                                          with_labels=(mode == "train"))
        return structs, {name: PSpec(mesh, (batch_pspec(mesh, B),))
                         for name in structs}
    # decode: one token + KV cache of shape.seq_len
    act = tf.dt(cfg.activation_dtype)
    token = _meta((B, 1), torch.int32)
    tok_shard = PSpec(mesh, (batch_pspec(mesh, B),))
    cache = tf.init_cache(cfg, B, shape.seq_len, device="meta")
    cache_shard = cache_pspecs(cache, mesh)
    extras, extra_shards = {}, {}
    if cfg.vision:
        shp = (B, cfg.vision.num_tokens, cfg.vision.vision_dim)
        extras["vision"] = _meta(shp, act)
        extra_shards["vision"] = PSpec(mesh, (batch_pspec(mesh, B),))
    if cfg.encoder:
        shp = (B, cfg.encoder.num_frames, cfg.d_model)
        extras["enc_out"] = _meta(shp, act)
        extra_shards["enc_out"] = PSpec(mesh, (batch_pspec(mesh, B),))
    return (token, cache, extras), (tok_shard, cache_shard, extra_shards)


def cache_pspecs(cache, mesh):
    """KV/state cache shardings. Leaves are [L(stacked), B, ...]: batch
    shards over data; the first trailing dim divisible by the model axis
    (the sequence axis for KV-major attention caches [L,B,H,S,D]; heads for
    SSM state) shards over model; the rest replicate."""
    msize = mesh.shape.get("model", 1)

    def spec(leaf):
        shp = leaf.shape
        s = [None] * len(shp)
        if len(shp) >= 2:
            s[1] = batch_pspec(mesh, shp[1])
        if "model" in mesh.axis_names:
            for d in range(2, len(shp)):
                if shp[d] % msize == 0 and shp[d] >= msize:
                    s[d] = "model"
                    break
        return PSpec(mesh, s)

    return unflatten(cache, [spec(x) for _, x in leaves_with_paths(cache)])


# ---------------------------------------------------------------------------
# step functions to trace
# ---------------------------------------------------------------------------

def make_steps(cfg: ModelConfig, opt_cfg: AdamWConfig = None):
    """(train_step, prefill_step, serve_step). The train step updates its
    params, optimizer state and error feedback in place, the counterpart
    of the reference's donated buffers; the serve step writes its cache in
    place."""
    from ..train.trainer import make_train_step
    opt_cfg = opt_cfg or AdamWConfig()
    train_step = make_train_step(cfg, opt_cfg, donate=True)

    def prefill_step(params, batch):
        logits, aux = tf.forward(params, cfg, batch, last_only=True)
        return logits[:, 0]

    def serve_step(params, token, cache, pos, extras):
        logits, new_cache = tf.decode_step(params, cfg, token, cache, pos,
                                           ctx_extra=extras or None)
        return logits[:, 0], new_cache

    return train_step, prefill_step, serve_step


def abstract_state(cfg: ModelConfig, mesh, seed: int = 0,
                   zero1: bool = True):
    """Meta params/opt/err + their PSpecs (no allocation): the params in
    ``cfg.param_dtype``, the moments and error feedback in f32."""
    params = tf.init_params(cfg, seed, "meta")
    pspecs = param_pspecs(params, mesh)
    ospecs = zero1_pspecs(params, mesh, zero1)
    f32 = lambda tree: unflatten(tree, [_meta(p.shape, torch.float32)
                                        for _, p in leaves_with_paths(tree)])
    opt = OptState(f32(params), f32(params), _meta((), torch.int32))
    err = f32(params)
    return params, pspecs, opt, ospecs, err
