"""GQA attention blocks (qk-norm, logit softcap, local windows) over dense
and paged KV caches: the GQA half of ``repro.models.attention`` in PyTorch.

Full-sequence paths use a grouped einsum (no KV-head repeat). The cached
paths keep the reference's ``use_flash`` seam: when it is set and the layer
has no softcap and no local window, the attention core is the CUDA
flash-decode / chunked-prefill kernel (via :mod:`repro_torch.kernels.ops`;
the plain version on CPU tensors), otherwise a torch-op core.

Caches are updated in place (the counterpart of the reference's donated
buffers): the functions still return the caches, which are the tensors they
were given. A write the reference drops (``.at[...].set(mode="drop")`` or an
out-of-window position) is filtered out before the write, since an
out-of-range index on CUDA is a device assert, not a drop.
MLA and cross-attention are not ported yet.
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


# ---------------------------------------------------------------------------
# core grouped attention
# ---------------------------------------------------------------------------

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


def _chunk_scatter(cache_k, cache_v, k, v, pos):
    """Write a contiguous Sq-token chunk of keys and values (k, v:
    [B,Sq,Hkv,Dh]) into the caches' sequence axis (axis 2 of
    [B,Hkv,Smax,Dh]) at per-row start positions ``pos`` [B], in place.
    Entries whose positions fall outside the window write nothing, so a
    sentinel ``pos >= Smax`` masks a row out of the batched call entirely
    (the reference's drop-out-of-range contract). One host sync (the entry
    filter) serves both caches."""
    Smax, Sq = cache_k.shape[2], k.shape[1]
    idx = pos.long()[:, None] + torch.arange(Sq, device=k.device)[None]
    rows, cols = ((idx >= 0) & (idx < Smax)).nonzero(as_tuple=True)
    s = idx[rows, cols]
    # (rows, :, s) selects [n, Hkv, Dh]
    cache_k[rows, :, s] = k[rows, cols].to(cache_k.dtype)
    cache_v[rows, :, s] = v[rows, cols].to(cache_v.dtype)


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


def _page_write(k_pages, v_pages, phys, off, k, v):
    """{k,v}_pages[phys, :, off, :] = k, v for every (row, token) whose
    ``phys`` is a real page, in place; sentinel entries (``>= n_pages``)
    write nothing. k, v: [B,Q,Hkv,Dh]. One host sync (the entry filter)
    serves both pools."""
    rows, cols = (phys < k_pages.shape[0]).nonzero(as_tuple=True)
    p, o = phys[rows, cols], off[rows, cols]
    k_pages[p, :, o] = k[rows, cols].to(k_pages.dtype)
    v_pages[p, :, o] = v[rows, cols].to(v_pages.dtype)


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
