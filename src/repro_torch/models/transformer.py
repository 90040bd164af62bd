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
from .common import dt, embed_init, dense_init, rms_norm, softcap
from ..configs.base import ModelConfig

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
        {k: cp[k] for k in ("wq", "wk", "wv", "wo", "gate")}, h,
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
    rp = p["rwkv"]
    st, tm_last, cm_last = ((cache["state"], cache["tm_shift"],
                             cache["cm_shift"]) if cache is not None
                            else (None, None, None))
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    y, new_state, tm_shift = ssmm.rwkv_time_mix(rp, h, cfg, st, tm_last)
    x = x + y
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    y2, cm_shift = ssmm.rwkv_channel_mix(rp, h2, cfg, cm_last)
    _store(cache, {"state": new_state, "tm_shift": tm_shift,
                   "cm_shift": cm_shift})
    return x + y2


def _mamba_layer(p, x, cfg, cache=None):
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
    h = torch.cat([x, x0.to(x.dtype)], dim=-1) @ sp["in_proj"][inv]
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
# reference's ``dots_with_no_batch_dims_saveable``); the rest is recomputed
_DOTS = ("mm", "bmm", "addmm")


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    saved = {getattr(torch.ops.aten, n).default for n in _DOTS}
    return (CheckpointPolicy.MUST_SAVE if op in saved
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
    x = params["embed"][tokens.long()].to(dt(cfg.activation_dtype))
    if cfg.name.startswith("gemma"):
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    if not cfg.use_rope:
        pos = (torch.arange(tokens.shape[1], device=tokens.device)[None, :]
               if positions is None else positions).long()
        table = params["pos_embed"]
        # a position past the table (an engine's sentinel row) reads NaN,
        # as the reference's ``jnp.take`` fills it; it never indexes out
        inside = (pos >= 0) & (pos < table.shape[0])
        pe = table[pos.clamp(0, table.shape[0] - 1)].to(x.dtype)
        x = x + torch.where(inside[..., None], pe, float("nan"))
    return x


def _logits(params, cfg, x):
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    w = params["embed"].t() if cfg.tie_embeddings else params["unembed"]
    logits = torch.einsum("bsd,dv->bsv", x, w.to(x.dtype))
    if cfg.final_logit_softcap:
        logits = softcap(logits.float(), cfg.final_logit_softcap)
    return logits


def _run_encoder(params, cfg, frames):
    """whisper's encoder: learned frame positions, non-causal layers,
    ``ln_post``."""
    ep = params["encoder"]
    x = frames.to(dt(cfg.activation_dtype)) + ep["pos"][None].to(frames.dtype)
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
    ctx = {"positions": torch.arange(tokens.shape[1],
                                     device=tokens.device)[None, :],
           **_context(params, cfg, batch)}
    if cfg.family == "hybrid":
        ctx["x0"] = x
    x, aux, _ = _apply_stack(params, cfg, x, ctx)
    if last_only:
        x = x[:, -1:]
    return _logits(params, cfg, x), aux


def loss_fn(params, cfg: ModelConfig, batch):
    """Next-token NLL in f32 (through logsumexp), plus the MoE aux losses
    over ``num_layers``. Returns (loss, metrics) with ``nll``, ``loss``
    and, for MoE configs, ``z_loss``, ``lb_loss`` and ``dropped_frac``."""
    logits, aux = forward(params, cfg, batch)
    labels = batch["labels"].long()
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, labels[..., None])[..., 0]
    nll = torch.mean(lse - gold)
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
    pos = torch.as_tensor(pos, device=token.device)
    positions = pos.reshape(-1).expand(B)[:, None]
    x = _embed_tokens(params, cfg, token, positions=positions)
    ctx = {"positions": positions}
    if use_flash:
        ctx["use_flash"] = True
    if ctx_extra:
        ctx.update(ctx_extra)
    if cfg.family == "hybrid":
        ctx["x0"] = x
    x, _, cache = _apply_stack(params, cfg, x, ctx, cache=cache, pos=pos)
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
