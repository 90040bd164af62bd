"""Attention blocks (``repro.models.attention`` in PyTorch): GQA (qk-norm,
logit softcap, local windows) and MLA (DeepSeek-V2 latent attention,
absorbed-matmul decode over a compressed latent cache) over dense and
paged caches, and cross-attention (whisper's decoder, the VLM's image
layers).

Full-sequence paths use a grouped einsum (no KV-head repeat), and above
``BLOCKED_THRESHOLD`` tokens the query-blocked loop of
:func:`blocked_attention`, whose scores never exceed one block's. The cached
paths keep the reference's ``use_flash`` seam: when it is set and the layer
has no softcap and no local window, the attention core is the CUDA
flash-decode / chunked-prefill kernel (via :mod:`repro_torch.kernels.ops`;
the plain version on CPU tensors), otherwise a torch-op core.

Caches are updated in place (the counterpart of the reference's donated
buffers): the functions still return the caches, which are the tensors they
were given. A write the reference drops (``.at[...].set(mode="drop")`` or an
out-of-window position) is filtered out before the write, since an
out-of-range index on CUDA is a device assert, not a drop.

MLA and cross-attention take no kernel, as in the reference (its MLA entry
points take ``**_`` and ignore ``use_flash``): their products are torch
ops. Where the reference asks for f32 products of bf16 operands
(``preferred_element_type``), the operands are upcast first.
"""
from __future__ import annotations

import torch

from .common import (apply_rope, causal_mask, dense_init, local_mask,
                     rms_norm, softcap)
from ..kernels import ops as kops

NEG_INF = -2.0 ** 30  # large-negative that survives bf16


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------

def init_gqa(seed, path, cfg, dtype, device, lead=()):
    D, H, Hkv, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    lead = tuple(lead)

    def w(name, shape):
        return dense_init(seed, f"{path}/{name}", lead + shape, dtype, device,
                          fan_in=shape[-2])

    p = {"wq": w("wq", (D, H, Dh)), "wk": w("wk", (D, Hkv, Dh)),
         "wv": w("wv", (D, Hkv, Dh)), "wo": w("wo", (H, Dh, D))}
    if cfg.qk_norm:
        p["q_gamma"] = torch.zeros(lead + (Dh,), dtype=dtype, device=device)
        p["k_gamma"] = torch.zeros(lead + (Dh,), dtype=dtype, device=device)
    return p


def init_mla(seed, path, cfg, dtype, device, lead=()):
    m, D, H = cfg.mla, cfg.d_model, cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    lead = tuple(lead)

    def w(name, shape):
        # the reference's fan-in is shape[-2]: H for wq_b/wk_b/wv_b
        return dense_init(seed, f"{path}/{name}", lead + shape, dtype, device,
                          fan_in=shape[-2])

    zeros = lambda n: torch.zeros(lead + (n,), dtype=dtype, device=device)
    return {
        "wq_a": w("wq_a", (D, m.q_lora_rank)),
        "q_ln": zeros(m.q_lora_rank),
        "wq_b": w("wq_b", (m.q_lora_rank, H, qk)),
        "wkv_a": w("wkv_a", (D, m.kv_lora_rank + m.qk_rope_head_dim)),
        "kv_ln": zeros(m.kv_lora_rank),
        "wk_b": w("wk_b", (m.kv_lora_rank, H, m.qk_nope_head_dim)),
        "wv_b": w("wv_b", (m.kv_lora_rank, H, m.v_head_dim)),
        "wo": w("wo", (H, m.v_head_dim, D)),
    }


def init_cross_attn(seed, path, cfg, kv_dim, dtype, device, lead=()):
    D, H, Hkv, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    lead = tuple(lead)

    def w(name, shape):
        return dense_init(seed, f"{path}/{name}", lead + shape, dtype, device,
                          fan_in=shape[-2])

    return {"wq": w("wq", (D, H, Dh)), "wk": w("wk", (kv_dim, Hkv, Dh)),
            "wv": w("wv", (kv_dim, Hkv, Dh)), "wo": w("wo", (H, Dh, D)),
            # the VLM's tanh gate on the residual
            "gate": torch.zeros(lead, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# core grouped attention
# ---------------------------------------------------------------------------

BLOCKED_THRESHOLD = 2048   # use q-blocked attention above this seq length


def blocked_attention(q, k, v, *, causal=True, window=None, cap=None,
                      q_offset=0, block_q=512):
    """Memory-bounded attention: a loop over query blocks with the full K/V
    resident (scores never exceed [B,Hkv,G,block_q,Skv], f32). GQA without
    KV repeat. This is the long-sequence path (prefill_32k / train_4k).

    The last block is shorter where ``block_q`` does not divide Sq (the
    reference asserts there). Under ``causal`` a block reads only the keys
    up to its last query's position: the columns past it are masked for
    every row of the block, and a masked score adds exactly 0 to the
    softmax and to P·V (a block whose first row precedes position 0 reads
    every key). One Python loop over the blocks serves both of the
    reference's lowerings (its ``unroll``, which changes no number)."""
    B, Sq, H, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    block_q = min(block_q, Sq)
    qg = q.reshape(B, Sq, Hkv, G, Dh)
    kh = k.float().permute(0, 2, 1, 3)              # [B,Hkv,Skv,Dh]
    vh = v.float().permute(0, 2, 1, 3)              # [B,Hkv,Skv,Dv]
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    outs = []
    for start in range(0, Sq, block_q):
        n = min(block_q, Sq - start)
        q_pos = torch.arange(start, start + n,
                             device=q.device)[:, None] + q_offset
        # a row before position 0 has every key masked (a uniform softmax
        # over all Skv keys), so such a block reads them all
        hi = (min(Skv, start + n + q_offset)
              if causal and start + q_offset >= 0 else Skv)
        s = torch.einsum("bqhgd,bhkd->bhgqk",
                         qg[:, start:start + n].float(),
                         kh[:, :, :hi]) * (Dh ** -0.5)
        if cap is not None:
            s = softcap(s, cap)
        mask = torch.ones((n, hi), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos[:, :hi] <= q_pos
        if window is not None:
            mask &= k_pos[:, :hi] > q_pos - window
        w = _masked_softmax(s, mask[None, None, None])
        outs.append(torch.einsum("bhgqk,bhkd->bqhgd",
                                 w.to(v.dtype).float(), vh[:, :, :hi]))
        del s, w                    # one block's scores live at a time
    out = torch.cat(outs, dim=1)
    return out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def _masked_softmax(scores, mask):
    scores = torch.where(mask, scores,
                         torch.tensor(NEG_INF, device=scores.device))
    return torch.softmax(scores, dim=-1)


def grouped_attention(q, k, v, mask, cap=None):
    """q: [B,Sq,H,Dh]; k,v: [B,Sk,Hkv,Dh]; mask: [B?,Sq,Sk] or [Sq,Sk] bool.

    Returns [B,Sq,H,Dh]. Grouped (GQA) without repeating KV heads; scores
    and softmax in f32.
    """
    B, Sq, H, Dh = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, Dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k.float()) * (Dh ** -0.5)
    if cap is not None:
        scores = softcap(scores, cap)
    if mask is not None:
        if mask.dim() == 2:                    # [Sq,Sk]
            mask = mask[None, None, None]
        elif mask.dim() == 3:                  # [B,Sq,Sk]
            mask = mask[:, None, None]
        w = _masked_softmax(scores, mask)
    else:
        w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w.to(v.dtype).float(), v.float())
    return out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def _proj_qkv(p, x, cfg, positions):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_gamma"], cfg.norm_eps)
        k = rms_norm(k, p["k_gamma"], cfg.norm_eps)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_forward(p, x, cfg, *, layer_kind="global", positions=None,
                causal=True):
    """Full-sequence self attention. x: [B,S,D]."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _proj_qkv(p, x, cfg, positions)
    window = cfg.local_window if (layer_kind == "local" and causal) else None
    if S > BLOCKED_THRESHOLD:
        out = blocked_attention(q, k, v, causal=causal, window=window,
                                cap=cfg.attn_logit_softcap)
    else:
        if not causal:
            mask = None
        elif window:
            mask = local_mask(S, S, window, device=x.device)
        else:
            mask = causal_mask(S, S, device=x.device)
        out = grouped_attention(q, k, v, mask, cfg.attn_logit_softcap)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def _flash_ok(cfg, layer_kind) -> bool:
    """The kernels implement neither a logit softcap nor a local window."""
    return not cfg.attn_logit_softcap and \
        not (layer_kind == "local" and cfg.local_window)


def _decode_core(q, cache_k, cache_v, positions, cfg, layer_kind, x_dtype,
                 *, use_flash=False):
    """Shared cached-context attention core over a dense KV window.
    q: [B,Sq,H,Dh] (Sq == 1 for decode, a token chunk for chunked prefill);
    cache_{k,v}: [B,Hkv,S,Dh] (KV-major); positions: [B,Sq] — each query row
    attends to cached positions <= its own. ``use_flash`` (on a layer with
    no softcap/local window) takes the decode kernel for one-token rows and
    the chunked-prefill kernel otherwise."""
    B, Sq, H, Dh = q.shape
    Hkv, S = cache_k.shape[1], cache_k.shape[2]
    G = H // Hkv
    window = cfg.local_window if layer_kind == "local" else None
    if use_flash and _flash_ok(cfg, layer_kind):
        if Sq == 1:
            out = kops.decode_attention(q[:, 0], cache_k, cache_v,
                                        positions[:, 0].to(torch.int32),
                                        kv_layout="bhsd")
            return out[:, None].to(x_dtype)
        out = kops.prefill_attention(q, cache_k, cache_v,
                                     positions[:, 0].to(torch.int32))
        return out.to(x_dtype)
    kv_pos = torch.arange(S, device=q.device)[None, None, :]
    valid = kv_pos <= positions[:, :, None]          # [B, Sq, S]
    if window:
        valid &= kv_pos > positions[:, :, None] - window
    qg = q.reshape(B, Sq, Hkv, G, Dh)
    scores = torch.einsum("bqhgd,bhkd->bhgqk", qg.float(),
                          cache_k.float()) * (Dh ** -0.5)
    if cfg.attn_logit_softcap:
        scores = softcap(scores, cfg.attn_logit_softcap)
    w = _masked_softmax(scores, valid[:, None, None])
    out = torch.einsum("bhgqk,bhkd->bqhgd", w.to(cache_v.dtype).float(),
                       cache_v.float())
    return out.reshape(B, Sq, H, Dh).to(x_dtype)


def _at_seq(t, first, s):
    """The index of ``t`` at ``first`` on axis 0 and ``s`` on the sequence
    axis, which is -2 in every cache and pool leaf (GQA [.., Hkv, S, Dh],
    MLA [.., S, R])."""
    return (first,) + (slice(None),) * (t.dim() - 3) + (s,)


def _chunk_scatter(cache_a, cache_b, a, b, pos):
    """Write a contiguous Sq-token chunk (a, b: [B,Sq,...]: GQA keys and
    values, or MLA latents) into the caches' sequence axis at per-row start
    positions ``pos`` [B], in place. Entries whose positions fall outside
    the window write nothing, so a sentinel ``pos >= Smax`` masks a row
    out of the batched call entirely (the reference's drop-out-of-range
    contract). One host sync (the entry filter) serves both caches."""
    Smax, Sq = cache_a.shape[-2], a.shape[1]
    idx = pos.long()[:, None] + torch.arange(Sq, device=a.device)[None]
    rows, cols = ((idx >= 0) & (idx < Smax)).nonzero(as_tuple=True)
    s = idx[rows, cols]
    cache_a[_at_seq(cache_a, rows, s)] = a[rows, cols].to(cache_a.dtype)
    cache_b[_at_seq(cache_b, rows, s)] = b[rows, cols].to(cache_b.dtype)


def gqa_decode(p, x, cfg, cache_k, cache_v, pos, *, layer_kind="global",
               use_flash=False):
    """One-token decode. x: [B,1,D]; cache_{k,v}: [B,Hkv,Smax,Dh];
    pos: scalar (int or 0-d tensor), or [B] per-row positions.

    Cache write: a scalar ``pos`` writes one token into every row when it
    is in range (the reference's guarded ``dynamic_update_slice``); a
    vector ``pos`` writes each row at its own position and drops rows
    out of range (the reference's mask write). Both leave the same cache.
    Returns (out [B,1,D], cache_k, cache_v)."""
    B = x.shape[0]
    Smax = cache_k.shape[2]
    pos_t = torch.as_tensor(pos, device=x.device)
    positions = pos_t.reshape(-1).expand(B)[:, None]
    q, k, v = _proj_qkv(p, x, cfg, positions)        # k,v: [B,1,Hkv,Dh]
    if pos_t.dim() == 0:
        p0 = int(pos_t)
        if 0 <= p0 < Smax:
            cache_k[:, :, p0] = k[:, 0].to(cache_k.dtype)
            cache_v[:, :, p0] = v[:, 0].to(cache_v.dtype)
    else:
        _chunk_scatter(cache_k, cache_v, k, v, positions[:, 0])
    out = _decode_core(q, cache_k, cache_v, positions, cfg, layer_kind,
                       x.dtype, use_flash=use_flash)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), cache_k, cache_v


def gqa_prefill_step(p, x, cfg, cache_k, cache_v, pos, *,
                     layer_kind="global", use_flash=False):
    """Cached-context chunked prefill over the dense slot cache.

    x: [B,Sq,D] — an Sq-token prompt chunk per row, starting at per-row
    cache position ``pos`` [B]; cache_{k,v}: [B,Hkv,Smax,Dh]. The chunk's
    K/V are written into the window first, then each query at pos+i attends
    to the pos+i cached prefix plus the chunk itself. Rows with ``pos >=
    Smax`` write nothing and their outputs are garbage (the scheduler's
    masked-row convention). Returns (out [B,Sq,D], caches)."""
    B, Sq, _ = x.shape
    positions = pos[:, None] + torch.arange(Sq, device=x.device)[None, :]
    q, k, v = _proj_qkv(p, x, cfg, positions)
    _chunk_scatter(cache_k, cache_v, k, v, pos)
    out = _decode_core(q, cache_k, cache_v, positions, cfg, layer_kind,
                       x.dtype, use_flash=use_flash)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), cache_k, cache_v


def _page_lookup(page_table, positions, ps, n_pages):
    """(physical page, in-page offset) per (row, token) for an append at
    ``positions`` [B,Q]; unmapped entries — negative table slots or logical
    pages past the table — land on the ``n_pages`` sentinel, which
    :func:`_page_write` drops (an out-of-table position must never clamp
    onto a live, possibly shared, page)."""
    P = page_table.shape[1]
    positions = positions.long()
    logical = torch.div(positions, ps, rounding_mode="floor")
    off = positions - logical * ps
    phys = torch.gather(page_table.long(), 1, torch.clamp(logical, 0, P - 1))
    phys = torch.where((phys < 0) | (logical >= P),
                       torch.full_like(phys, n_pages), phys)
    return phys, off


def _page_write(pages_a, pages_b, phys, off, a, b):
    """pages[phys, .., off, :] = a, b for every (row, token) whose ``phys``
    is a real page, in place; sentinel entries (``>= n_pages``) write
    nothing. a, b: [B,Q,...] (GQA keys and values, or MLA latents). One
    host sync (the entry filter) serves both pools."""
    rows, cols = (phys < pages_a.shape[0]).nonzero(as_tuple=True)
    p, o = phys[rows, cols], off[rows, cols]
    pages_a[_at_seq(pages_a, p, o)] = a[rows, cols].to(pages_a.dtype)
    pages_b[_at_seq(pages_b, p, o)] = b[rows, cols].to(pages_b.dtype)


def _paged_window(pages, page_table):
    """Dense KV-major window of every row: [B, Hkv, P*ps, Dh]."""
    n_pages, Hkv, ps, Dh = pages.shape
    B, P = page_table.shape
    d = pages[torch.clamp(page_table.long(), 0, n_pages - 1)]
    return d.permute(0, 2, 1, 3, 4).reshape(B, Hkv, P * ps, Dh)


def gqa_decode_paged(p, x, cfg, k_pages, v_pages, page_table, pos, *,
                     layer_kind="global", use_flash=False):
    """One-token decode against a paged KV cache (serving fast path).

    k_pages/v_pages: [n_pages, Hkv, page_size, Dh] — the tenant's page pool;
    page_table: [B, P] int32 (entries >= n_pages unmapped); pos: scalar or
    [B]. The append touches one page entry per row and unmapped rows drop
    their writes. ``use_flash`` reads the pages through the page table
    inside the kernel; the torch-op core gathers a dense [B, P*page_size]
    window first. Returns (out [B,1,D], k_pages, v_pages)."""
    B = x.shape[0]
    n_pages, Hkv, ps, Dh = k_pages.shape
    positions = torch.as_tensor(pos, device=x.device).reshape(-1) \
        .expand(B)[:, None]
    q, k, v = _proj_qkv(p, x, cfg, positions)        # k,v: [B,1,Hkv,Dh]
    phys, off = _page_lookup(page_table, positions, ps, n_pages)
    _page_write(k_pages, v_pages, phys, off, k, v)
    if use_flash and _flash_ok(cfg, layer_kind):
        out = kops.decode_attention_paged(q[:, 0], k_pages, v_pages,
                                          page_table,
                                          positions[:, 0].to(torch.int32))
        out = out[:, None].to(x.dtype)
    else:
        out = _decode_core(q, _paged_window(k_pages, page_table),
                           _paged_window(v_pages, page_table), positions,
                           cfg, layer_kind, x.dtype)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), k_pages, v_pages


def gqa_prefill_paged(p, x, cfg, k_pages, v_pages, page_table, pos, *,
                      layer_kind="global", use_flash=False):
    """Cached-context chunked prefill against a paged KV cache: the paged
    counterpart of :func:`gqa_prefill_step`. x: [B,Sq,D]; pos: [B] chunk
    starts. The Sq appends write one (page, offset) entry per token (rows
    with unmapped or out-of-table positions drop); the read side goes
    through the chunked-prefill kernel under ``use_flash``, else through a
    dense window view. Returns (out [B,Sq,D], k_pages, v_pages)."""
    B, Sq, _ = x.shape
    n_pages, Hkv, ps, Dh = k_pages.shape
    positions = pos[:, None] + torch.arange(Sq, device=x.device)[None, :]
    q, k, v = _proj_qkv(p, x, cfg, positions)        # k,v: [B,Sq,Hkv,Dh]
    phys, off = _page_lookup(page_table, positions, ps, n_pages)
    _page_write(k_pages, v_pages, phys, off, k, v)
    if use_flash and _flash_ok(cfg, layer_kind):
        out = kops.prefill_attention_paged(q, k_pages, v_pages, page_table,
                                           pos.to(torch.int32))
        out = out.to(x.dtype)
    else:
        out = _decode_core(q, _paged_window(k_pages, page_table),
                           _paged_window(v_pages, page_table), positions,
                           cfg, layer_kind, x.dtype)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), k_pages, v_pages


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------

def _mla_q(p, x, cfg, positions):
    m = cfg.mla
    ql = rms_norm(torch.einsum("bsd,dr->bsr", x, p["wq_a"]), p["q_ln"],
                  cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bshk", ql, p["wq_b"])
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions,
                        cfg.rope_theta)
    return q_nope, q_rope


def _mla_latent(p, x, cfg, positions):
    m = cfg.mla
    kv = torch.einsum("bsd,dr->bsr", x, p["wkv_a"])
    c_kv = rms_norm(kv[..., :m.kv_lora_rank], p["kv_ln"], cfg.norm_eps)
    k_rope = apply_rope(kv[..., None, m.kv_lora_rank:], positions,
                        cfg.rope_theta)
    return c_kv, k_rope[..., 0, :]                  # [B,S,R], [B,S,rope]


def mla_forward(p, x, cfg, *, positions=None, causal=True, **_):
    """Full-sequence MLA with expanded keys/values: the rope sub-dim is
    folded into per-head keys so the grouped attention core applies."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    c_kv, k_rope = _mla_latent(p, x, cfg, positions)
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, p["wk_b"])
    v = torch.einsum("bsr,rhk->bshk", c_kv, p["wv_b"])
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, m.qk_rope_head_dim)], dim=-1)
    # rescale so the core's 1/sqrt(d) matches MLA's
    d_eff = m.qk_nope_head_dim + m.qk_rope_head_dim
    ratio = (d_eff ** -0.5) / (q_full.shape[-1] ** -0.5)
    if abs(ratio - 1.0) > 1e-9:
        q_full = q_full * ratio
    if S > BLOCKED_THRESHOLD:
        out = blocked_attention(q_full, k_full, v, causal=causal)
    else:
        mask = causal_mask(S, S, device=x.device) if causal else None
        out = grouped_attention(q_full, k_full, v, mask)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def _mla_core(p, x, cfg, q_nope, q_rope, cache_ckv, cache_krope, positions):
    """Absorbed-matmul attention over a dense latent window. cache_ckv:
    [B,S,R]; cache_krope: [B,S,rope]; positions: [B,Sq] — each query row
    attends to latents at positions <= its own. Scores and the latent
    output are f32 products of the (upcast) operands."""
    m = cfg.mla
    Smax = cache_ckv.shape[1]
    q_eff = torch.einsum("bqhk,rhk->bqhr", q_nope, p["wk_b"])
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    scores = (torch.einsum("bqhr,bsr->bhqs", q_eff.float(),
                           cache_ckv.float())
              + torch.einsum("bqhk,bsk->bhqs", q_rope.float(),
                             cache_krope.float())) * scale
    valid = (torch.arange(Smax, device=x.device)[None, None, :]
             <= positions[:, :, None])[:, None]          # [B,1,Sq,S]
    w = _masked_softmax(scores, valid)
    o_latent = torch.einsum("bhqs,bsr->bqhr",
                            w.to(cache_ckv.dtype).float(), cache_ckv.float())
    out = torch.einsum("bqhr,rhn->bqhn", o_latent.to(x.dtype), p["wv_b"])
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def mla_decode(p, x, cfg, cache_ckv, cache_krope, pos, **_):
    """Absorbed-matmul MLA decode against the compressed latent cache
    (cache_ckv: [B,Smax,R]; cache_krope: [B,Smax,rope]). A scalar ``pos``
    writes every row at ``pos`` when it is in range (the reference's
    guarded ``dynamic_update_slice``), a vector ``pos`` each row at its own
    position, dropping rows out of range: both leave the same cache.
    Returns (out [B,1,D], cache_ckv, cache_krope)."""
    B = x.shape[0]
    Smax = cache_ckv.shape[1]
    pos_t = torch.as_tensor(pos, device=x.device)
    positions = pos_t.reshape(-1).expand(B)[:, None]
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    c_kv, k_rope = _mla_latent(p, x, cfg, positions)
    if pos_t.dim() == 0:
        p0 = int(pos_t)
        if 0 <= p0 < Smax:
            cache_ckv[:, p0] = c_kv[:, 0].to(cache_ckv.dtype)
            cache_krope[:, p0] = k_rope[:, 0].to(cache_krope.dtype)
    else:
        _chunk_scatter(cache_ckv, cache_krope, c_kv, k_rope,
                       positions[:, 0])
    return (_mla_core(p, x, cfg, q_nope, q_rope, cache_ckv, cache_krope,
                      positions), cache_ckv, cache_krope)


def mla_prefill_step(p, x, cfg, cache_ckv, cache_krope, pos, **_):
    """Cached-context chunked MLA prefill: the Sq-token chunk's latents go
    into the dense latent window at per-row start positions ``pos`` [B],
    then each query attends to its own latent prefix. Returns (out
    [B,Sq,D], caches)."""
    B, Sq, _ = x.shape
    positions = pos[:, None] + torch.arange(Sq, device=x.device)[None, :]
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    c_kv, k_rope = _mla_latent(p, x, cfg, positions)
    _chunk_scatter(cache_ckv, cache_krope, c_kv, k_rope, pos)
    return (_mla_core(p, x, cfg, q_nope, q_rope, cache_ckv, cache_krope,
                      positions), cache_ckv, cache_krope)


def _mla_paged(p, x, cfg, ckv_pages, krope_pages, page_table, positions):
    """The paged MLA step for appends at ``positions`` [B,Sq]: one (page,
    offset) latent row per token (unmapped entries drop), then attention
    over each row's gathered window of P * page_size tokens."""
    B = x.shape[0]
    n_pages, ps, R = ckv_pages.shape
    P = page_table.shape[1]
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    c_kv, k_rope = _mla_latent(p, x, cfg, positions)
    phys, off = _page_lookup(page_table, positions, ps, n_pages)
    _page_write(ckv_pages, krope_pages, phys, off, c_kv, k_rope)
    pt = torch.clamp(page_table.long(), 0, n_pages - 1)
    ckv = ckv_pages[pt].reshape(B, P * ps, R)
    krope = krope_pages[pt].reshape(B, P * ps, krope_pages.shape[-1])
    return (_mla_core(p, x, cfg, q_nope, q_rope, ckv, krope, positions),
            ckv_pages, krope_pages)


def mla_decode_paged(p, x, cfg, ckv_pages, krope_pages, page_table, pos,
                     **_):
    """Paged MLA decode: the latent cache lives in a shared page pool
    (ckv_pages: [n_pages, page_size, R]; krope_pages: [n_pages, page_size,
    rope]; page_table: [B, P], entries >= n_pages unmapped). Returns (out
    [B,1,D], pools)."""
    B = x.shape[0]
    positions = torch.as_tensor(pos, device=x.device).reshape(-1) \
        .expand(B)[:, None]
    return _mla_paged(p, x, cfg, ckv_pages, krope_pages, page_table,
                      positions)


def mla_prefill_paged(p, x, cfg, ckv_pages, krope_pages, page_table, pos,
                      **_):
    """Cached-context chunked MLA prefill against the paged latent pool:
    Sq latent appends per row at start positions ``pos`` [B]. Returns
    (out [B,Sq,D], pools)."""
    Sq = x.shape[1]
    positions = pos[:, None] + torch.arange(Sq, device=x.device)[None, :]
    return _mla_paged(p, x, cfg, ckv_pages, krope_pages, page_table,
                      positions)


# ---------------------------------------------------------------------------
# cross attention (enc-dec / VLM)
# ---------------------------------------------------------------------------

def cross_attn_forward(p, x, kv_feats, cfg, gated=False):
    """x: [B,S,D]; kv_feats: [B,T,kv_dim] (encoder output / patch
    embeddings). ``gated`` scales the output by ``tanh(gate)`` (in f32,
    then cast)."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    kv = kv_feats.to(x.dtype)
    k = torch.einsum("btd,dhk->bthk", kv, p["wk"])
    v = torch.einsum("btd,dhk->bthk", kv, p["wv"])
    out = grouped_attention(q, k, v, mask=None, cap=cfg.attn_logit_softcap)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    if gated:
        out = torch.tanh(p["gate"].float()).to(out.dtype) * out
    return out
