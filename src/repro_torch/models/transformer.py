"""The decoder model of ``repro.models.transformer`` in PyTorch, for the
pure-attention GQA configs (``stablelm-1.6b``, ``qwen3-1.7b``, ``gemma2``,
``nemotron``): every config the paged serving engine runs without MLA or MoE.
Any other family raises ``NotImplementedError``.

Entry points:
    init_params(cfg, seed, device, dtype)   -> params dict
    forward(params, cfg, batch)             -> (logits, aux)
    init_cache(cfg, B, max_seq)             -> cache dict
    init_paged_cache(cfg, n_pages, page)    -> page-pool cache dict
    decode_step(params, cfg, token, cache, pos, ctx_extra) -> (logits, cache)
    prefill_step(params, cfg, tokens, cache, pos, ctx_extra) -> (logits, cache)
    prefill(params, cfg, batch, max_seq)    -> (logits_last, cache)

Params and caches keep the reference's structure: ``embed``, ``final_ln``,
optional ``unembed``, the ``prefix`` list, and ``layers`` whose leaves are
stacked ``[n_periods, ...]``. The layer stack is a Python loop over the
periods (the reference scans), indexing each stacked leaf; caches are
written in place through those views.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from . import attention as attn
from . import mlp as mlpm
from .common import dt, embed_init, dense_init, rms_norm, softcap
from ..configs.base import ModelConfig


def _kind_base(kind: str) -> str:
    return kind[: -len("_shared")] if kind.endswith("_shared") else kind


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
    """Raise ``NotImplementedError`` for what the port does not run yet."""
    if not pageable(cfg) or cfg.attn_type != "gqa" or cfg.moe:
        raise NotImplementedError(
            f"{cfg.name}: only pure-attention GQA decoders without MoE are "
            "ported (MLA, MoE, SSM, hybrid, encoder and vision models are "
            "later slices)")


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

def _init_layer(seed, path, cfg, dtype, device, lead=()):
    D = cfg.d_model
    lead = tuple(lead)
    zeros = lambda: torch.zeros(lead + (D,), dtype=dtype, device=device)
    p: Dict[str, Any] = {
        "ln1": zeros(),
        "attn": attn.init_gqa(seed, path + "/attn", cfg, dtype, device, lead),
        "ln2": zeros(),
        "mlp": mlpm.init_mlp(seed, path + "/mlp", D, cfg.d_ff, cfg.mlp_act,
                             dtype, device, lead),
    }
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
    n_prefix, _, period, n_periods = _pattern_segments(cfg)
    if n_prefix:
        params["prefix"] = [_init_layer(seed, f"prefix/{i}", cfg, dtype,
                                        device) for i in range(n_prefix)]
    if n_periods:
        params["layers"] = {
            f"s{j}": _init_layer(seed, f"layers/s{j}", cfg, dtype, device,
                                 lead=(n_periods,))
            for j in range(len(period))}
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


def _attn_layer(p, x, cfg, kind, ctx, cache=None, pos=None):
    """Pre-norm attention + MLP block. Returns (x, new_cache)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    new_cache = cache
    if cache is None:
        a = attn.gqa_forward(p["attn"], h, cfg, layer_kind=kind,
                             positions=ctx.get("positions"),
                             causal=ctx.get("causal", True))
    else:
        chunk = ctx.get("chunk", False)
        flash = ctx.get("use_flash", False)
        if "page_table" in ctx:
            # paged cache: leaves are shared page pools, addressed through
            # the per-row page table; ``ctx["chunk"]`` switches one-token
            # decode to the cached-context chunked prefill contract
            fn = attn.gqa_prefill_paged if chunk else attn.gqa_decode_paged
            a, ck, cv = fn(p["attn"], h, cfg, cache["k"], cache["v"],
                           ctx["page_table"], pos, layer_kind=kind,
                           use_flash=flash)
        else:
            fn = attn.gqa_prefill_step if chunk else attn.gqa_decode
            a, ck, cv = fn(p["attn"], h, cfg, cache["k"], cache["v"], pos,
                           layer_kind=kind, use_flash=flash)
        new_cache = {"k": ck, "v": cv}
    x = x + _maybe_post(a, p, "ln1_post", cfg)
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    m = mlpm.mlp_forward(p["mlp"], h2, cfg.mlp_act)
    return x + _maybe_post(m, p, "ln2_post", cfg), new_cache


def _apply_stack(params, cfg, x, ctx, cache=None, pos=None):
    """Prefix layers, then the period loop over the stacked leaves. Cache
    leaves are updated in place; the returned cache is the one given."""
    n_prefix, prefix_kind, period, n_periods = _pattern_segments(cfg)
    for i in range(n_prefix):
        c = cache["prefix"][i] if cache is not None else None
        x, _ = _attn_layer(cast_tree(params["prefix"][i], cfg), x, cfg,
                           prefix_kind, ctx, c, pos)
    for i in range(n_periods):
        for j, kind in enumerate(period):
            p = tree_map(lambda a: a[i], params["layers"][f"s{j}"])
            c = (tree_map(lambda a: a[i], cache["layers"][f"s{j}"])
                 if cache is not None else None)
            x, _ = _attn_layer(cast_tree(p, cfg), x, cfg, _kind_base(kind),
                               ctx, c, pos)
    return x, cache


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def _embed_tokens(params, cfg, tokens, positions=None):
    x = params["embed"][tokens.long()].to(dt(cfg.activation_dtype))
    if cfg.name.startswith("gemma"):
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    if not cfg.use_rope:
        pos = (torch.arange(tokens.shape[1], device=tokens.device)[None, :]
               if positions is None else positions)
        x = x + params["pos_embed"][pos.long()].to(x.dtype)
    return x


def _logits(params, cfg, x):
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    w = params["embed"].t() if cfg.tie_embeddings else params["unembed"]
    logits = torch.einsum("bsd,dv->bsv", x, w.to(x.dtype))
    if cfg.final_logit_softcap:
        logits = softcap(logits.float(), cfg.final_logit_softcap)
    return logits


def forward(params, cfg: ModelConfig, batch, last_only: bool = False):
    check_supported(cfg)
    tokens = batch["tokens"]
    x = _embed_tokens(params, cfg, tokens)
    ctx = {"positions": torch.arange(tokens.shape[1],
                                     device=tokens.device)[None, :]}
    x, _ = _apply_stack(params, cfg, x, ctx)
    if last_only:
        x = x[:, -1:]
    return _logits(params, cfg, x), {}


def _layer_cache(cfg, lead, S, dtype, device):
    shape = tuple(lead) + (cfg.num_kv_heads, S, cfg.head_dim)
    # KV-major [.., Hkv, S, Dh]: the attention cores read it as is
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_cache(cfg: ModelConfig, B: int, max_seq: int, dtype=None,
               device="cuda"):
    check_supported(cfg)
    dtype = dtype or dt(cfg.activation_dtype)
    n_prefix, _, period, n_periods = _pattern_segments(cfg)
    cache: Dict[str, Any] = {}
    if n_prefix:
        cache["prefix"] = [_layer_cache(cfg, (B,), max_seq, dtype, device)
                           for _ in range(n_prefix)]
    cache["layers"] = {f"s{j}": _layer_cache(cfg, (n_periods, B), max_seq,
                                             dtype, device)
                       for j in range(len(period))}
    return cache


def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int,
                     dtype=None, device="cuda"):
    """Page-pool KV cache: the structure of :func:`init_cache` with the
    slot axis a shared page-pool axis and the sequence axis one page
    ([n_pages, Hkv, page_size, Dh] per layer). Slots address the pool
    through the [n_slots, P] page table passed as
    ``ctx_extra={"page_table": ...}``."""
    if not pageable(cfg):
        raise ValueError(f"{cfg.name} is not pageable")
    return init_cache(cfg, n_pages, page_size, dtype, device)


def decode_step(params, cfg: ModelConfig, token, cache, pos, ctx_extra=None,
                use_flash: bool = False):
    """token: [B,1] int; pos: scalar OR [B] per-row positions.
    ``ctx_extra={"page_table": [B,P] int32}`` switches attention layers to
    the paged pools; ``use_flash`` routes eligible layers through the
    flash-decode kernel. Returns (logits [B,1,V], cache)."""
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
    x, cache = _apply_stack(params, cfg, x, ctx, cache=cache, pos=pos)
    return _logits(params, cfg, x), cache


def prefill_step(params, cfg: ModelConfig, tokens, cache, pos,
                 ctx_extra=None, use_flash: bool = False):
    """One cached-context prefill chunk: ``tokens`` [B,Sq] whose rows start
    at per-row cache position ``pos`` [B]. Each query at pos+i attends to
    the pos+i cached KV plus the chunk itself, and the chunk's KV lands in
    the cache. Rows at an out-of-window sentinel position write nothing.
    ``ctx_extra={"page_table": [B,P]}`` switches to the paged pools;
    ``use_flash`` routes eligible layers through the chunked-prefill kernel.
    Returns (last-position logits [B,1,V], cache)."""
    check_supported(cfg)
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
    x, cache = _apply_stack(params, cfg, x, ctx, cache=cache, pos=pos)
    return _logits(params, cfg, x[:, -1:]), cache


def prefill(params, cfg: ModelConfig, batch, max_seq: int):
    """Reference prompt processing: one decode step per prompt token into a
    fresh dense cache. Returns (last logits [B,1,V], cache)."""
    tokens = batch["tokens"]
    cache = init_cache(cfg, tokens.shape[0], max_seq, device=tokens.device)
    logits = None
    for t in range(tokens.shape[1]):
        logits, cache = decode_step(params, cfg, tokens[:, t:t + 1], cache,
                                    torch.tensor(t, device=tokens.device))
    return logits, cache
