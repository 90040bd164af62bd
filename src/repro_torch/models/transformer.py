"""The unified model of ``repro.models.transformer`` in PyTorch, for every
config of ``ARCHS``: the GQA decoders (``stablelm-1.6b``, ``qwen3-1.7b``,
``gemma2``, ``nemotron``), the MoE family (``moonshot-v1-16b-a3b``: GQA
with MoE MLPs after a dense prefix; ``deepseek-v2-236b``: MLA and MoE), the
SSM family (``rwkv6-7b``), the hybrid family (``zamba2-1.2b``: mamba2
layers and a shared GQA attention block), the encoder-decoder
(``whisper-small``: a non-causal encoder, cross-attention after each
decoder layer) and the VLM (``llama-3.2-vision-90b``: gated
cross-attention layers over image features).

Entry points:
    init_params(cfg, seed, device, dtype)   -> params dict
    forward(params, cfg, batch)             -> (logits, aux)
    loss_fn(params, cfg, batch)             -> (loss, metrics)
    init_cache(cfg, B, max_seq)             -> cache dict
    init_paged_cache(cfg, n_pages, page)    -> page-pool cache dict
    decode_step(params, cfg, token, cache, pos, ctx_extra) -> (logits, cache)
    prefill_step(params, cfg, tokens, cache, pos, ctx_extra) -> (logits, cache)
    prefill(params, cfg, batch, max_seq)    -> (logits_last, cache)

Encoder and vision models take their context in ``batch`` (``frames`` or
``enc_out``; ``vision``) for :func:`forward` and :func:`prefill`, and in
``ctx_extra`` for :func:`decode_step`. MoE configs' :func:`forward`
returns the reference's aux dict (``z_loss``, ``lb_loss``,
``dropped_frac``, each summed over the layers); other configs return
``{}``.

Params and caches keep the reference's structure: ``embed``, ``final_ln``,
optional ``unembed``, the ``prefix`` list, and ``layers`` whose leaves are
stacked ``[n_periods, ...]``. The layer stack is a Python loop over the
periods (the reference scans), indexing each stacked leaf; without a cache
and with grad enabled, ``cfg.remat`` checkpoints each period ("full":
recompute it in the backward pass; "dots": keep its matrix products),
as the reference's ``jax.checkpoint`` of the scan body does. Caches are
written in place through those views (attention writes into them; SSM
layers compute new state, conv and shift tensors, which are copied in).
Hybrids keep the shared block's params in ``shared`` and its KV cache in
``cache["layers"]["shared"]``, stacked per period. MLA layers cache the
latents ``ckv`` [.., S, R] and ``krope`` [.., S, rope]; cross layers have
no cache. The whisper encoder's layers are stacked under
``encoder/layers``, the decoder's cross blocks under ``cross``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from . import attention as attn
from . import mlp as mlpm
from . import moe as moem
from . import ssm as ssmm
from .common import dt, embed_init, dense_init, rms_norm, softcap, wide
from ..configs.base import ModelConfig
from ..dist.sharding import (Reduced, axes_of, current_mesh, hint,
                             local_call, mesh_gather, reshard, spec_of,
                             take_rows)

# a layer kind ending with this also fires the hybrid's shared block
SHARED_SUFFIX = "_shared"
SSM_KINDS = ("rwkv", "mamba")
LAYER_KINDS = ("global", "local", "cross", *SSM_KINDS)


def _kind_base(kind: str) -> str:
    return (kind[: -len(SHARED_SUFFIX)] if kind.endswith(SHARED_SUFFIX)
            else kind)


def pageable(cfg: ModelConfig) -> bool:
    """Paged KV is supported for pure-attention decoders (GQA or MLA,
    global/local layers only — SSM state, encoders, and vision cross-attn
    keep per-slot dense state)."""
    kinds = {_kind_base(k) for k in cfg.layer_pattern}
    return (kinds <= {"global", "local"} and cfg.attn_type in ("gqa", "mla")
            and not cfg.encoder and not cfg.vision
            and cfg.family != "hybrid")


def chunkable(cfg: ModelConfig) -> bool:
    """Cached-context chunked prefill (:func:`prefill_step`) is supported
    for the same family as :func:`pageable`."""
    return pageable(cfg)


def check_supported(cfg: ModelConfig):
    """Raise ``NotImplementedError`` for a layer kind or attention type the
    model does not know (every config of ``ARCHS`` passes)."""
    kinds = {_kind_base(k) for k in cfg.layer_pattern}
    attends = bool(kinds & {"global", "local"}) or cfg.family == "hybrid"
    if (not kinds <= set(LAYER_KINDS)
            or (attends and cfg.attn_type not in ("gqa", "mla"))):
        raise NotImplementedError(
            f"{cfg.name}: layer kinds {sorted(kinds)} with attention "
            f"{cfg.attn_type!r}; the model runs {LAYER_KINDS} with GQA or "
            "MLA")


def _pattern_segments(cfg: ModelConfig):
    """(n_prefix, prefix_kind, period_kinds, n_periods)."""
    n_prefix = cfg.n_prefix
    period = tuple(cfg.layer_pattern)
    n_rest = cfg.num_layers - n_prefix
    if n_rest < 0 or n_rest % len(period):
        raise ValueError((cfg.name, cfg.num_layers, n_prefix, period))
    return n_prefix, _kind_base(period[0]), period, n_rest // len(period)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def n_shared_invocations(cfg: ModelConfig) -> int:
    _, _, period, n_periods = _pattern_segments(cfg)
    per = sum(1 for k in period if k.endswith(SHARED_SUFFIX))
    return max(1, per * n_periods)


def _moe_flag(cfg, kind: str) -> bool:
    return bool(cfg.moe) and _kind_base(kind) in ("global", "local", "cross")


def _init_layer(seed, path, cfg, kind, dtype, device, lead=(),
                moe_layer=False):
    kind = _kind_base(kind)
    D = cfg.d_model
    lead = tuple(lead)
    zeros = lambda: torch.zeros(lead + (D,), dtype=dtype, device=device)
    if kind == "rwkv":
        return {"ln1": zeros(),
                "rwkv": ssmm.init_rwkv_block(seed, path + "/rwkv", cfg, dtype,
                                             device, lead),
                "ln2": zeros()}
    if kind == "mamba":
        return {"ln1": zeros(),
                "mamba": ssmm.init_mamba2_block(seed, path + "/mamba", cfg,
                                                dtype, device, lead)}
    if kind == "cross":
        a = attn.init_cross_attn(seed, path + "/attn", cfg,
                                 cfg.vision.vision_dim, dtype, device, lead)
    elif cfg.attn_type == "mla":
        a = attn.init_mla(seed, path + "/attn", cfg, dtype, device, lead)
    else:
        a = attn.init_gqa(seed, path + "/attn", cfg, dtype, device, lead)
    p: Dict[str, Any] = {"ln1": zeros(), "attn": a, "ln2": zeros()}
    if moe_layer:
        p["moe"] = moem.init_moe(seed, path + "/moe", cfg, dtype, device,
                                 lead)
    else:
        dff = cfg.d_ff
        if cfg.moe and cfg.moe.first_dense_layers and cfg.moe.d_ff_dense:
            dff = cfg.moe.d_ff_dense
        p["mlp"] = mlpm.init_mlp(seed, path + "/mlp", D, dff, cfg.mlp_act,
                                 dtype, device, lead)
    if cfg.name.startswith("gemma"):
        p["ln1_post"] = zeros()
        p["ln2_post"] = zeros()
    return p


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda", dtype=None):
    """Random weights from ``seed`` (one ``torch.Generator`` per leaf, see
    ``common.leaf_generator``). ``dtype`` defaults to ``cfg.param_dtype``;
    serving passes the activation dtype so the weights are held as they
    are used (what the reference's per-call ``cast_tree`` gives)."""
    check_supported(cfg)
    dtype = dtype or dt(cfg.param_dtype)
    D, V = cfg.d_model, cfg.vocab_size
    params: Dict[str, Any] = {
        "embed": embed_init(seed, "embed", (V, D), dtype, device),
        "final_ln": torch.zeros((D,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(seed, "unembed", (D, V), dtype, device)
    if not cfg.use_rope:
        params["pos_embed"] = embed_init(seed, "pos_embed",
                                         (cfg.max_position, D), dtype, device)
    n_prefix, prefix_kind, period, n_periods = _pattern_segments(cfg)
    if n_prefix:
        # an MoE config's prefix is its dense layers
        params["prefix"] = [_init_layer(seed, f"prefix/{i}", cfg, prefix_kind,
                                        dtype, device)
                            for i in range(n_prefix)]
    if n_periods:
        params["layers"] = {
            f"s{j}": _init_layer(seed, f"layers/s{j}", cfg, kind, dtype,
                                 device, lead=(n_periods,),
                                 moe_layer=_moe_flag(cfg, kind))
            for j, kind in enumerate(period)}
    if cfg.family == "hybrid":
        params["shared"] = {
            "ln1": torch.zeros((D,), dtype=dtype, device=device),
            "attn": attn.init_gqa(seed, "shared/attn", cfg, dtype, device),
            "ln2": torch.zeros((D,), dtype=dtype, device=device),
            "mlp": mlpm.init_mlp(seed, "shared/mlp", D, cfg.d_ff,
                                 cfg.mlp_act, dtype, device),
            "in_proj": dense_init(seed, "shared/in_proj",
                                  (n_shared_invocations(cfg), 2 * D, D),
                                  dtype, device),
        }
    if cfg.encoder:
        enc = {"pos": embed_init(seed, "enc/pos",
                                 (cfg.encoder.num_frames, D), dtype, device),
               "ln_post": torch.zeros((D,), dtype=dtype, device=device)}
        if cfg.encoder.num_layers:
            enc["layers"] = _init_layer(seed, "enc/layer", cfg, "global",
                                        dtype, device,
                                        lead=(cfg.encoder.num_layers,))
        params["encoder"] = enc
        if n_periods:
            params["cross"] = {
                "ln": torch.zeros((n_periods, D), dtype=dtype, device=device),
                **attn.init_cross_attn(seed, "dec/cross", cfg, D, dtype,
                                       device, lead=(n_periods,))}
    return params


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------

def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def cast_tree(p, cfg):
    """Floating leaves in the activation dtype (a no-op for weights already
    held in it)."""
    dtype = dt(cfg.activation_dtype)
    return tree_map(lambda a: a.to(dtype) if a.is_floating_point() else a, p)


def _maybe_post(h, p, name, cfg):
    return rms_norm(h, p[name], cfg.norm_eps) if name in p else h


def _mlp_or_moe(p, h, cfg, aux):
    """The block's MLP, or its MoE layer, whose aux losses are added into
    ``aux`` in place (when it is given)."""
    if "moe" in p:
        out, a = moem.moe_forward(p["moe"], h, cfg)
        if aux is not None:
            for k, v in a.items():
                aux[k] = aux.get(k, 0.0) + v
        return out
    return mlpm.mlp_forward(p["mlp"], h, cfg.mlp_act)


def _attn_layer(p, x, cfg, kind, ctx, cache=None, pos=None, aux=None):
    """Pre-norm attention + MLP/MoE block. Returns (x, new_cache)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    new_cache = cache
    mla = cfg.attn_type == "mla"
    if kind == "cross":
        a = attn.cross_attn_forward(p["attn"], h, ctx["vision"], cfg,
                                    gated=True)
    elif cache is None:
        fwd = attn.mla_forward if mla else attn.gqa_forward
        a = fwd(p["attn"], h, cfg, layer_kind=kind,
                positions=ctx.get("positions"),
                causal=ctx.get("causal", True))
    else:
        chunk = ctx.get("chunk", False)
        flash = ctx.get("use_flash", False)
        names = ("ckv", "krope") if mla else ("k", "v")
        c0, c1 = cache[names[0]], cache[names[1]]
        if "page_table" in ctx:
            # paged cache: leaves are shared page pools, addressed through
            # the per-row page table; ``ctx["chunk"]`` switches one-token
            # decode to the cached-context chunked prefill contract
            if mla:
                fn = attn.mla_prefill_paged if chunk else attn.mla_decode_paged
            else:
                fn = attn.gqa_prefill_paged if chunk else attn.gqa_decode_paged
            a, c0, c1 = fn(p["attn"], h, cfg, c0, c1, ctx["page_table"], pos,
                           layer_kind=kind, use_flash=flash)
        else:
            if mla:
                fn = attn.mla_prefill_step if chunk else attn.mla_decode
            else:
                fn = attn.gqa_prefill_step if chunk else attn.gqa_decode
            a, c0, c1 = fn(p["attn"], h, cfg, c0, c1, pos, layer_kind=kind,
                           use_flash=flash)
        new_cache = dict(zip(names, (c0, c1)))
    x = x + _maybe_post(a, p, "ln1_post", cfg)
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    m = _mlp_or_moe(p, h2, cfg, aux)
    return x + _maybe_post(m, p, "ln2_post", cfg), new_cache


def _whisper_cross(cp, x, cfg, ctx):
    """whisper's decoder cross-attention over the encoder output, after a
    decoder layer's whole block (ungated)."""
    cp = cast_tree(cp, cfg)
    h = rms_norm(x, cp["ln"], cfg.norm_eps)
    a = attn.cross_attn_forward(
        {k: cp[k] for k in ("wq", "wk", "wv", "wo")}, h,
        ctx["enc_out"], cfg, gated=False)
    return x + a


def _store(cache, new):
    """Copy an SSM layer's new state into its cache views (in place): the
    rows of every slot advance, sentinel rows included, as in the
    reference, where only attention writes drop."""
    if cache is not None:
        for name, t in new.items():
            cache[name].copy_(t)


def _rwkv_layer(p, x, cfg, cache=None):
    """The rwkv6 layer (time mix, channel mix, their norms and residuals;
    a cache's state and token shifts advanced in place). In a mesh, where
    XLA's compiled program places the reference's: each rank on its rows
    of ``x`` (a cache's rows in a decode step), its heads split over
    "model" (where they divide). Every product takes its input whole on
    d_model and gives its output split with the heads (r, k, v, g and the
    decay's LoRA out, the time mix's ``tm_wo`` after its input is
    gathered, the channel mix's key and receptance); the scan, the group
    norm and the gate run on each rank's heads; the channel mix's value
    product, split on its input as placed, sums its partial products (an
    all-reduce). The weights move to those placements, the activations
    are gathered back to ``x``'s. A cache's state stays where it is
    placed (rows, heads), its token shifts are gathered whole for the
    step and written back in their own placement. Without a mesh every
    placement is the identity."""
    rp = p["rwkv"]
    H = cfg.d_model // cfg.ssm.head_dim
    mesh = current_mesh()
    m = ("model" if mesh is not None and "model" in mesh.axis_names
         and H % mesh.shape["model"] == 0 else None)
    x0s = spec_of(x)
    if cache is not None:
        x = reshard(x, spec_of(cache["state"])[:1] + x0s[1:])
    xs = spec_of(x)
    heads, state = xs[:-1] + (m,), xs[:1] + (m, None, None)
    col, row = (None, m), (m, None)
    c = cache or {}
    dw = rp["decay_w"]
    names = ("tm_mix", "tm_wr", "tm_wk", "tm_wv", "tm_wg", "bonus", "ln_x")

    def time_mix(h, st, last, a, b, base, *w):
        q = dict(zip(names, w), decay_w={"a": a, "b": b, "base": base})
        return ssmm.time_mix_heads(q, h, cfg, st, last)

    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    y, new_state, tm_shift = local_call(
        time_mix, h, c.get("state"), c.get("tm_shift"), dw["a"], dw["b"],
        dw["base"], *(rp[n] for n in names),
        in_specs=[xs, state, xs, (), col, row, (), col, col, col, col, row,
                  (m,)], out_specs=[heads, state, xs])
    y = local_call(lambda y, w: y @ w, reshard(y, xs), rp["tm_wo"],
                   in_specs=[xs, col], out_specs=[heads])
    x = x + reshard(y, xs)
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    kv, r, cm_shift = local_call(
        lambda h, last, mix, wk, wv, wr: ssmm.channel_mix_parts(
            {"cm_mix": mix, "cm_wk": wk, "cm_wv": wv, "cm_wr": wr}, h, last),
        h2, c.get("cm_shift"), rp["cm_mix"], rp["cm_wk"], rp["cm_wv"],
        rp["cm_wr"], in_specs=[xs, xs, (), col, row, col],
        out_specs=[Reduced(xs, axes_of(m)) if m else xs, heads, xs])
    if cache is not None:
        _store(cache, {"state": new_state,
                       "tm_shift": reshard(tm_shift,
                                           spec_of(cache["tm_shift"])),
                       "cm_shift": reshard(cm_shift,
                                           spec_of(cache["cm_shift"]))})
    return reshard(x + torch.sigmoid(reshard(r, xs)) * kv, x0s)


def _mamba_layer(p, x, cfg, cache=None):
    """The mamba2 layer (its norm, block and residual; a cache's state and
    conv window advanced in place). In a mesh, where XLA's compiled
    program places the reference's: each rank on its rows of ``x`` (a
    cache's rows in a decode step), its heads split over "model" (where
    they divide). ``in_proj`` and ``conv`` are gathered whole (their
    contiguous split does not line up with z, x, B, C and dt) and each
    rank takes its heads' z, x and dt columns and x channels, and B and C
    whole; the conv, the scan, ``d_skip`` and the gate run on its heads;
    the gated norm divides by the mean of squares over all of d_in, its
    per-rank sums summed over "model" (an f32 [B,T,1] all-reduce); the
    output product, on ``out_proj``'s row block as placed, sums its
    partial products. A cache's state steps where the heads are and goes
    back to its own placement; its conv window is gathered whole for the
    step, each rank's x channels gathered back after it. Heads that
    "model" does not divide run whole on every rank. Without a mesh,
    :func:`repro_torch.models.ssm.mamba2_block` as it stands."""
    if current_mesh() is None:
        return _mamba(p, x, cfg, cache)
    mp = p["mamba"]
    s = cfg.ssm
    P, N = s.head_dim, s.state_dim
    d_in = s.expand * cfg.d_model
    H = d_in // P
    mesh = current_mesh()
    n = mesh.shape.get("model", 1)
    m = "model" if n > 1 and H % n == 0 else None
    # this rank's heads [r * h, (r + 1) * h), their d_in channels
    n, r = (n, mesh.device_mesh.get_local_rank("model")) if m else (1, 0)
    h, dh = H // n, d_in // n
    x0s = spec_of(x)
    if cache is not None:
        x = reshard(x, spec_of(cache["state"])[:1] + x0s[1:])
    xs = spec_of(x)
    heads, state = xs[:-1] + (m,), xs[:1] + (m, None, None)
    window = xs[:1] + (None, None)
    c = cache or {}

    def mine(t, dim, at):
        """``t``'s slices (start, width, whether a head's) along ``dim``,
        each head's from this rank's heads on, joined"""
        return torch.cat([t.narrow(dim, a + r * w if per_head else a, w)
                          for a, w, per_head in at], dim=dim)

    # in_proj's z, x and dt columns of these heads, B's and C's whole;
    # conv's (and the window's) x channels, B's and C's
    cols = ((0, dh, True), (d_in, dh, True), (2 * d_in, 2 * N, False),
            (2 * (d_in + N), h, True))
    chans = ((0, dh, True), (d_in, 2 * N, False))

    def block(x, st, cv, w_in, conv, a_log, dt_bias, d_skip):
        q = {"in_proj": mine(w_in, 1, cols), "conv": mine(conv, 1, chans),
             "a_log": a_log, "dt_bias": dt_bias, "d_skip": d_skip}
        if cv is not None:
            cv = mine(cv, 2, chans)
        g, new_st, new_cv = ssmm.mamba2_heads(q, x, cfg, st, cv)
        sq = wide(g).square().sum(dim=-1, keepdim=True)
        if cv is None:
            return g, sq
        # the window's x channels of every rank, then B's and C's
        return g, sq, new_st, torch.cat(
            [mesh_gather(new_cv[..., :dh], 2, m), new_cv[..., dh:]], dim=2)

    hn = rms_norm(x, p["ln1"], cfg.norm_eps)
    g, sq, *new = local_call(
        block, hn, c.get("state"), c.get("conv"), mp["in_proj"], mp["conv"],
        mp["a_log"], mp["dt_bias"], mp["d_skip"],
        in_specs=[xs, state, window, (), (), (m,), (m,), (m,)],
        out_specs=[heads, Reduced(xs, axes_of(m)) if m else xs, state,
                   window])
    y = local_call(
        lambda g, sq, gamma, w: ssmm.gated_norm_out(g, sq, gamma, w, d_in,
                                                    cfg.norm_eps),
        g, sq, mp["out_norm"], mp["out_proj"],
        in_specs=[heads, xs, (m,), (m, None)],
        out_specs=[Reduced(xs, axes_of(m)) if m else xs])
    if cache is not None:
        _store(cache, {k: reshard(t, spec_of(cache[k]))
                       for k, t in zip(("state", "conv"), new)})
    return reshard(x + y, x0s)


def _mamba(p, x, cfg, cache):
    st, cv = ((cache["state"], cache["conv"]) if cache is not None
              else (None, None))
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    y, new_state, new_conv = ssmm.mamba2_block(p["mamba"], h, cfg, st, cv)
    _store(cache, {"state": new_state, "conv": new_conv})
    return x + y


def _shared_block(sp, x, x0, cfg, inv, ctx, cache=None, pos=None):
    """zamba2 shared attention block: concat(current, original embedding),
    the invocation's input projection, shared attn+MLP; the delta is added
    to the trunk."""
    sp = cast_tree(sp, cfg)
    xs = spec_of(x)
    # in a mesh: each rank's rows, the invocation's projection gathered
    h = local_call(lambda x, x0, w: torch.cat([x, x0.to(x.dtype)], dim=-1)
                   @ w, x, x0, sp["in_proj"][inv], in_specs=[xs, xs, ()],
                   out_specs=[xs])
    p = {k: sp[k] for k in ("ln1", "attn", "ln2", "mlp")}
    out, _ = _attn_layer(p, h, cfg, "global", ctx, cache, pos)
    return x + (out - h)


def _apply_one(p, x, cfg, kind, ctx, cache, pos, aux, period_idx):
    """One pattern slot (the shared block is fired by the caller; whisper's
    cross block of period ``period_idx`` here, after a global layer)."""
    p = cast_tree(p, cfg)
    base = _kind_base(kind)
    if base == "rwkv":
        return _rwkv_layer(p, x, cfg, cache)
    if base == "mamba":
        return _mamba_layer(p, x, cfg, cache)
    x = _attn_layer(p, x, cfg, base, ctx, cache, pos, aux)[0]
    if cfg.encoder and base == "global" and "cross_p" in ctx:
        x = _whisper_cross(_at(ctx["cross_p"], period_idx), x, cfg, ctx)
    return x


def _at(tree, i):
    return tree_map(lambda a: a[i], tree)


def _periods(tree, n):
    """The ``n`` periods' slices of a tree of stacked ``[n, ...]`` leaves
    (dicts of tensors), one ``unbind`` a leaf: under autograd its backward
    stacks the periods' gradients once, where indexing each period would
    write a zero-filled gradient of the whole stacked leaf per period."""
    if isinstance(tree, dict):
        per = {k: _periods(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(n)]
    return tree.unbind(0)


def _aux0(cfg, device):
    if cfg.moe:
        return {k: torch.zeros((), dtype=torch.float32, device=device)
                for k in ("z_loss", "lb_loss", "dropped_frac")}
    return {}


def _apply_stack(params, cfg, x, ctx, cache=None, pos=None):
    """Prefix layers, then the period loop over the stacked leaves, with
    the shared block after each ``*_shared`` slot (invocation ``i *
    n_shared_per + shared_i``). Cache leaves are updated in place; the
    returned cache is the one given. Returns (x, aux, cache), aux summed
    over the MoE layers."""
    aux = _aux0(cfg, x.device)
    n_prefix, prefix_kind, period, n_periods = _pattern_segments(cfg)
    for i in range(n_prefix):
        c = cache["prefix"][i] if cache is not None else None
        x = _apply_one(params["prefix"][i], x, cfg, prefix_kind, ctx, c, pos,
                       aux, 0)
    if cfg.encoder:
        ctx = dict(ctx, cross_p=params["cross"])
    n_shared_per = max(1, sum(1 for k in period if k.endswith(SHARED_SUFFIX)))

    layers = _periods(params["layers"], n_periods) if n_periods else []

    def body(x, aux, i):
        aux = dict(aux)             # a recomputation adds into its own copy
        shared_i = 0
        for j, kind in enumerate(period):
            c = _at(cache["layers"][f"s{j}"], i) if cache is not None else None
            x = _apply_one(layers[i][f"s{j}"], x, cfg, kind, ctx, c, pos,
                           aux, i)
            if kind.endswith(SHARED_SUFFIX):
                sc = (_at(cache["layers"]["shared"], i) if cache is not None
                      else None)
                x = _shared_block(params["shared"], x, ctx["x0"], cfg,
                                  i * n_shared_per + shared_i, ctx, sc, pos)
                shared_i += 1
        return x, aux

    if cache is None:
        body = _remat(cfg, body)
    for i in range(n_periods):
        x, aux = body(x, aux, i)
    return x, aux, cache


# the matrix products a "dots" period keeps for the backward pass (the
# reference's ``dots_with_no_batch_dims_saveable``: products with no batch
# dims, i.e. activations against weights: mm, addmm, and the bmm of one
# batch that an einsum against a weight dispatches to); batched products
# (attention scores, the experts' stacked GEMMs) and the rest are
# recomputed
_DOTS = ("mm", "addmm")


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    saved = {getattr(torch.ops.aten, n).default for n in _DOTS}
    keep = op in saved or (op is torch.ops.aten.bmm.default
                           and args[0].shape[0] == 1)
    return (CheckpointPolicy.MUST_SAVE if keep
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg, body):
    """``cfg.remat`` on a period's body: "full" recomputes the whole period
    in the backward pass, "dots" keeps its matrix products and recomputes
    the rest. Where autograd records nothing (no grad), it is the body."""
    if cfg.remat == "none":
        return body
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"remat {cfg.remat!r}")
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = lambda: create_selective_checkpoint_contexts(
            _dots_policy)

    def wrapped(x, aux, i):
        if not torch.is_grad_enabled():
            return body(x, aux, i)
        return checkpoint(body, x, aux, i, use_reentrant=False, **kw)
    return wrapped


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def _embed_tokens(params, cfg, tokens, positions=None):
    x = take_rows(params["embed"], tokens.long()).to(
        dt(cfg.activation_dtype))
    if cfg.name.startswith("gemma"):
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    if not cfg.use_rope:
        pos = (torch.arange(tokens.shape[1], device=tokens.device)[None, :]
               if positions is None else positions).long()
        table = params["pos_embed"]
        # in a mesh: on x's rows (whole where it broadcasts over them)
        pos = reshard(pos, spec_of(x)[:1] if pos.shape[0] == x.shape[0]
                      else ())
        # a position past the table (an engine's sentinel row) reads NaN,
        # as the reference's ``jnp.take`` fills it; it never indexes out
        inside = (pos >= 0) & (pos < table.shape[0])
        pe = take_rows(table, pos.clamp(0, table.shape[0] - 1))
        # in a mesh: the add on x's placement, the positions' rows brought
        # to it (x's rows, its split of d_model) by stated moves
        xs = spec_of(x)
        ps = (xs[0] if pe.shape[0] == x.shape[0] else None, None, xs[-1])
        x = local_call(
            lambda x, pe, inside: x + torch.where(
                inside[..., None], pe.to(x.dtype), float("nan")),
            x, pe, inside, in_specs=[xs, ps, ps[:2]], out_specs=[xs])
    return x


def _logits(params, cfg, x):
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    w = params["embed"].t() if cfg.tie_embeddings else params["unembed"]
    # in a mesh: each rank's rows against its own vocab columns (the
    # tied table split on the vocab as it is placed), never gathered
    xs, vs = spec_of(x), spec_of(w)[-1]
    logits = local_call(
        lambda x, w: torch.einsum("bsd,dv->bsv", x, w.to(x.dtype)), x, w,
        in_specs=[xs, (None, vs)], out_specs=[xs[:-1] + (vs,)])
    logits = hint(logits, "data", None, "model")
    if cfg.final_logit_softcap:
        logits = softcap(logits.float(), cfg.final_logit_softcap)
    return logits


def _run_encoder(params, cfg, frames):
    """whisper's encoder: learned frame positions, non-causal layers,
    ``ln_post``. In a mesh, each rank's rows of ``frames`` as they are
    placed, the positions gathered whole."""
    ep = params["encoder"]
    act = dt(cfg.activation_dtype)
    fs = spec_of(frames)
    x = local_call(lambda f, pos: f.to(act) + pos[None].to(f.dtype),
                   frames, ep["pos"], in_specs=[fs, ()], out_specs=[fs])
    for i in range(cfg.encoder.num_layers if "layers" in ep else 0):
        x, _ = _attn_layer(cast_tree(_at(ep["layers"], i), cfg), x, cfg,
                           "global", {"causal": False})
    return rms_norm(x, ep["ln_post"], cfg.norm_eps)


def _context(params, cfg, batch):
    """The model context a batch carries: image features, and the encoder
    output (given as ``enc_out``, or run from ``frames``)."""
    ctx = {}
    if cfg.vision:
        ctx["vision"] = batch["vision"]
    if cfg.encoder:
        ctx["enc_out"] = (batch["enc_out"] if "enc_out" in batch
                          else _run_encoder(params, cfg, batch["frames"]))
    return ctx


def forward(params, cfg: ModelConfig, batch, last_only: bool = False):
    """Full-sequence logits [B,S,V] (``last_only``: [B,1,V]) and the aux
    dict."""
    check_supported(cfg)
    tokens = batch["tokens"]
    x = _embed_tokens(params, cfg, tokens)
    x = hint(x, "data", None, None)
    ctx = {"positions": torch.arange(tokens.shape[1],
                                     device=tokens.device)[None, :],
           **_context(params, cfg, batch)}
    if cfg.family == "hybrid":
        ctx["x0"] = x
    x, aux, _ = _apply_stack(params, cfg, x, ctx)
    if last_only:
        x = x[:, -1:]
    return _logits(params, cfg, x), aux


def _vocab_sharded(logits) -> bool:
    """Whether ``logits`` is a DTensor whose vocab (last) dim is split
    over a mesh dim."""
    return any(p.is_shard(logits.dim() - 1)
               for p in getattr(logits, "placements", ()))


def _sharded_nll_terms(lf, labels):
    """logsumexp and the gold logit over vocab-sharded logits ``lf``
    [B,S,V], each rank on its own vocab columns, where the reference's
    compiled program keeps them: the row max (an all-reduce of max,
    outside the gradient, as any shift leaves logsumexp exact), the sum
    of exponentials and the gold logit read where this rank holds the
    label (all-reduces of sums). Nothing [B,S,V]-sized is gathered or
    built whole, forward or backward."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    spec = spec_of(lf)
    rows, vax = spec[:-1], axes_of(spec[-1])
    v0 = compute_local_shape_and_global_offset(
        lf.shape, lf.device_mesh, lf.placements)[1][-1]
    top = local_call(lambda l: l.detach().amax(dim=-1), lf,
                     in_specs=[spec], out_specs=[Reduced(rows, vax, "max")])

    def parts(l, lab, top):
        n = l.shape[-1]
        rel = lab - v0
        gold = l.gather(-1, rel.clamp(0, n - 1)[..., None])[..., 0]
        gold = gold.masked_fill((rel < 0) | (rel >= n), 0.0)
        return torch.exp(l - top[..., None]).sum(dim=-1), gold

    sumexp, gold = local_call(parts, lf, labels, top,
                              in_specs=[spec, rows, rows],
                              out_specs=[Reduced(rows, vax),
                                         Reduced(rows, vax)])
    return top + torch.log(sumexp), gold


# the whole-vocabulary NLL's blocks of rows: one block's f32 logits stay
# within about NLL_BLOCK_BYTES, and a block holds at least NLL_MIN_ROWS
# rows (all of them where there are fewer). CUDA's row reduction splits
# each row of a call over several thread blocks when the call has few
# rows (at most 4 x the card's SMs: 528 on an H100), and that order of
# summation moves ``lse`` in its last bit; from 1024 rows up each row is
# summed as in one call over all the rows, so the loss and the gradient
# are the whole-tensor form's bit for bit
NLL_BLOCK_BYTES = 256 << 20
NLL_MIN_ROWS = 1024


def _nll_blocks(rows: int, vocab: int):
    """The (start, stop) of each block of ``rows`` rows: as few blocks as
    keep one block's f32 logits within NLL_BLOCK_BYTES, but none under
    NLL_MIN_ROWS rows, their sizes within one row of each other."""
    n = -(-rows * vocab * 4 // NLL_BLOCK_BYTES)
    n = max(1, min(n, rows // NLL_MIN_ROWS))
    cuts = [rows * i // n for i in range(n + 1)]
    return list(zip(cuts[:-1], cuts[1:]))


class _BlockedNll(torch.autograd.Function):
    """Per-row ``logsumexp(l) - l[label]`` in f32 over logits whose
    vocabulary is whole, a block of rows at a time (:func:`_nll_blocks`):
    each block's logits are cast to f32 only while it runs. It keeps the
    logits in their own dtype and the f32 ``lse`` a row for the backward
    pass, which writes ``exp(l - lse) * g``, less ``g`` at the label,
    into one gradient in the logits' dtype, a block at a time (one
    rounding, as the backward pass of ``logits.float()`` rounds). The
    plain version is :func:`_nll_terms_plain`, which holds [rows, V] f32
    buffers whole."""

    @staticmethod
    def forward(ctx, logits, labels):
        V = logits.shape[-1]
        l2, lab = logits.reshape(-1, V), labels.reshape(-1, 1)
        lse, nll = [], []
        for a, b in _nll_blocks(l2.shape[0], V):
            lf = l2[a:b].float()
            lse.append(torch.logsumexp(lf, dim=-1))
            nll.append(lse[-1] - lf.gather(-1, lab[a:b])[:, 0])
            del lf                  # one block's f32 logits at a time
        lse = torch.cat(lse)
        ctx.save_for_backward(logits, lse, labels)
        return torch.cat(nll).reshape(labels.shape)

    @staticmethod
    def backward(ctx, g):
        logits, lse, labels = ctx.saved_tensors
        V = logits.shape[-1]
        l2, lab = logits.reshape(-1, V), labels.reshape(-1, 1)
        g = g.reshape(-1, 1)
        grad = torch.empty_like(l2)
        for a, b in _nll_blocks(l2.shape[0], V):
            d = (l2[a:b].float() - lse[a:b, None]).exp_()
            d.mul_(g[a:b]).scatter_add_(-1, lab[a:b], -g[a:b])
            grad[a:b] = d
            del d                   # one block's f32 gradient at a time
        return grad.reshape(logits.shape), None


def _nll_terms(logits, labels):
    """Per-row NLL terms (``lse - gold``, f32) of logits whose vocabulary
    is whole on this rank: :class:`_BlockedNll`."""
    return _BlockedNll.apply(logits, labels)


def _nll_terms_plain(logits, labels):
    """The plain version of :func:`_nll_terms` (for the tests and
    ``chip_smoke.py``): the logits cast to f32 whole, then logsumexp and
    the gold logit, autograd keeping [rows, V] f32 buffers."""
    lf = logits.float()
    return (torch.logsumexp(lf, dim=-1)
            - lf.gather(-1, labels[..., None])[..., 0])


def loss_fn(params, cfg: ModelConfig, batch):
    """Next-token NLL in f32 (through logsumexp), plus the MoE aux losses
    over ``num_layers``. Returns (loss, metrics) with ``nll``, ``loss``
    and, for MoE configs, ``z_loss``, ``lb_loss`` and ``dropped_frac``."""
    logits, aux = forward(params, cfg, batch)
    labels = batch["labels"].long()
    if _vocab_sharded(logits):
        lse, gold = _sharded_nll_terms(logits.float(), labels)
        terms = lse - gold
    else:
        # the vocabulary whole (one device; in a mesh each rank's rows:
        # whisper's vocabulary, which "model" does not divide)
        rows = spec_of(logits)[:-1]
        terms = local_call(_nll_terms, logits, labels,
                           in_specs=[rows + (None,), rows],
                           out_specs=[rows])
    nll = torch.mean(terms)
    loss = nll
    metrics = {"nll": nll}
    for k in ("z_loss", "lb_loss"):
        if k in aux:
            loss = loss + aux[k] / max(cfg.num_layers, 1)
            metrics[k] = aux[k]
    if "dropped_frac" in aux:
        metrics["dropped_frac"] = aux["dropped_frac"] / max(cfg.num_layers, 1)
    metrics["loss"] = loss
    return loss, metrics


def _layer_cache(cfg, kind, lead, S, dtype, device):
    """One layer's cache with leading axes ``lead`` (``(B,)``, or
    ``(n_periods, B)`` for the stack). SSM state is f32; conv and shift
    rows are in the activation dtype."""
    kind = _kind_base(kind)
    lead = tuple(lead)
    zeros = lambda *shape, dt_=dtype: torch.zeros(lead + shape, dtype=dt_,
                                                  device=device)
    D, s = cfg.d_model, cfg.ssm
    if kind == "cross":
        return {}
    if cfg.attn_type == "mla":
        m = cfg.mla
        return {"ckv": zeros(S, m.kv_lora_rank),
                "krope": zeros(S, m.qk_rope_head_dim)}
    if kind == "rwkv":
        H = D // s.head_dim
        return {"state": zeros(H, s.head_dim, s.head_dim, dt_=torch.float32),
                "tm_shift": zeros(1, D), "cm_shift": zeros(1, D)}
    if kind == "mamba":
        d_in = s.expand * D
        return {"state": zeros(d_in // s.head_dim, s.state_dim, s.head_dim,
                               dt_=torch.float32),
                "conv": zeros(s.conv_dim - 1, d_in + 2 * s.state_dim)}
    # KV-major [.., Hkv, S, Dh]: the attention cores read it as is
    return {"k": zeros(cfg.num_kv_heads, S, cfg.head_dim),
            "v": zeros(cfg.num_kv_heads, S, cfg.head_dim)}


def init_cache(cfg: ModelConfig, B: int, max_seq: int, dtype=None,
               device="cuda"):
    check_supported(cfg)
    dtype = dtype or dt(cfg.activation_dtype)
    n_prefix, prefix_kind, period, n_periods = _pattern_segments(cfg)
    cache: Dict[str, Any] = {}
    if n_prefix:
        cache["prefix"] = [_layer_cache(cfg, prefix_kind, (B,), max_seq,
                                        dtype, device)
                           for _ in range(n_prefix)]
    lead = (n_periods, B)
    cache["layers"] = {f"s{j}": _layer_cache(cfg, kind, lead, max_seq, dtype,
                                             device)
                       for j, kind in enumerate(period)}
    if any(k.endswith(SHARED_SUFFIX) for k in period):
        cache["layers"]["shared"] = _layer_cache(cfg, "global", lead,
                                                 max_seq, dtype, device)
    return cache


def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int,
                     dtype=None, device="cuda"):
    """Page-pool KV cache: the structure of :func:`init_cache` with the
    slot axis a shared page-pool axis and the sequence axis one page
    ([n_pages, Hkv, page_size, Dh] per layer). Slots address the pool
    through the [n_slots, P] page table passed as
    ``ctx_extra={"page_table": ...}``; [n_pages, page_size, R] and
    [n_pages, page_size, rope] latent pools for MLA."""
    if not pageable(cfg):
        raise ValueError(f"{cfg.name} is not pageable")
    return init_cache(cfg, n_pages, page_size, dtype, device)


def decode_step(params, cfg: ModelConfig, token, cache, pos, ctx_extra=None,
                use_flash: bool = False):
    """token: [B,1] int; pos: scalar OR [B] per-row positions.
    ``ctx_extra={"page_table": [B,P] int32}`` switches attention layers to
    the paged pools; ``use_flash`` routes eligible GQA layers through the
    flash-decode kernel; ``ctx_extra`` also carries ``vision`` or
    ``enc_out``. Returns (logits [B,1,V], cache)."""
    check_supported(cfg)
    B = token.shape[0]
    # a Python int reaches the layers as it is (a meta tensor has no value)
    given = pos
    pos = torch.as_tensor(pos, device=token.device)
    positions = pos.reshape(-1).expand(B)[:, None]
    x = _embed_tokens(params, cfg, token, positions=positions)
    # in a mesh: the token's rows as placed, d_model whole (an embedding
    # split on d_model, whisper's, is gathered, as XLA does)
    x = reshard(x, spec_of(x)[:-1] + (None,))
    ctx = {"positions": positions}
    if use_flash:
        ctx["use_flash"] = True
    if ctx_extra:
        ctx.update(ctx_extra)
    if cfg.family == "hybrid":
        ctx["x0"] = x
    x, _, cache = _apply_stack(params, cfg, x, ctx, cache=cache,
                               pos=given if isinstance(given, int) else pos)
    return _logits(params, cfg, x), cache


def prefill_step(params, cfg: ModelConfig, tokens, cache, pos,
                 ctx_extra=None, use_flash: bool = False):
    """One cached-context prefill chunk: ``tokens`` [B,Sq] whose rows start
    at per-row cache position ``pos`` [B]. Each query at pos+i attends to
    the pos+i cached KV plus the chunk itself, and the chunk's KV lands in
    the cache. Rows at an out-of-window sentinel position write nothing.
    ``ctx_extra={"page_table": [B,P]}`` switches to the paged pools;
    ``use_flash`` routes eligible layers through the chunked-prefill kernel.
    Returns (last-position logits [B,1,V], cache). Only :func:`chunkable`
    configs: SSM state would have to step token by token."""
    check_supported(cfg)
    if not chunkable(cfg):
        raise ValueError(f"{cfg.name} is not chunkable; use prefill")
    B, Sq = tokens.shape
    pos = torch.as_tensor(pos, device=tokens.device).to(torch.int32) \
        .reshape(-1).expand(B)
    positions = pos[:, None] + torch.arange(Sq, device=tokens.device)[None]
    x = _embed_tokens(params, cfg, tokens, positions=positions)
    ctx = {"positions": positions, "chunk": True}
    if use_flash:
        ctx["use_flash"] = True
    if ctx_extra:
        ctx.update(ctx_extra)
    x, _, cache = _apply_stack(params, cfg, x, ctx, cache=cache, pos=pos)
    return _logits(params, cfg, x[:, -1:]), cache


def prefill(params, cfg: ModelConfig, batch, max_seq: int):
    """Reference prompt processing: one decode step per prompt token into a
    fresh dense cache, without the flash kernels (the serving engine's
    prompt path for models that are not :func:`chunkable`). ``batch``
    carries ``vision`` or ``frames`` where the model needs them. Returns
    (last logits [B,1,V], cache)."""
    tokens = batch["tokens"]
    cache = init_cache(cfg, tokens.shape[0], max_seq, device=tokens.device)
    ctx_extra = _context(params, cfg, batch)
    logits = None
    for t in range(tokens.shape[1]):
        logits, cache = decode_step(params, cfg, tokens[:, t:t + 1], cache,
                                    torch.tensor(t, device=tokens.device),
                                    ctx_extra=ctx_extra)
    return logits, cache
