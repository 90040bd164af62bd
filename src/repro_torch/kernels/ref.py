"""Plain PyTorch versions of the attention kernels (``repro.kernels.ref``).

They are the CPU path of :mod:`repro_torch.kernels.ops` and the yardstick the
CUDA kernels are held against on the card. Scores and softmax run in f32 with
the reference's finite ``NEG_INF``; outputs come back in the query dtype.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _attend(q, kr, vr, valid):
    """q: [B,Sq,H,D]; kr/vr: [B,S,H,D] (heads already repeated); valid:
    [B,Sq,S] bool. Returns [B,Sq,H,D] in q's dtype."""
    D = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) * D ** -0.5
    s = torch.where(valid[:, None], s, torch.tensor(NEG_INF, device=s.device))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, vr.float()).to(q.dtype)


def ref_decode_attention(q, k_cache, v_cache, pos):
    """q: [B,H,D]; caches: [B,Smax,Hkv,D]; pos scalar or [B] per-row."""
    B, H, D = q.shape
    Smax, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    kr = torch.repeat_interleave(k_cache, G, dim=2)
    vr = torch.repeat_interleave(v_cache, G, dim=2)
    pos_b = torch.as_tensor(pos, device=q.device).reshape(-1).expand(B)
    valid = torch.arange(Smax, device=q.device)[None, :] <= pos_b[:, None]
    return _attend(q[:, None], kr, vr, valid[:, None])[:, 0]


def ref_prefill_attention(q, k_cache, v_cache, pos):
    """Chunked-prefill oracle. q: [B,Sq,H,D]; caches: [B,Smax,Hkv,D]
    (the chunk's own keys already resident); pos: [B] chunk starts — query
    i of row b attends to cache positions <= pos[b] + i."""
    B, Sq, H, D = q.shape
    Smax, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    kr = torch.repeat_interleave(k_cache, G, dim=2)
    vr = torch.repeat_interleave(v_cache, G, dim=2)
    pos = torch.as_tensor(pos, device=q.device).reshape(-1).expand(B)
    q_pos = pos[:, None] + torch.arange(Sq, device=q.device)[None, :]
    valid = torch.arange(Smax, device=q.device)[None, None, :] \
        <= q_pos[:, :, None]                                    # [B,Sq,S]
    return _attend(q, kr, vr, valid)


def gather_pages(pages, page_table):
    """Dense per-row view of a page pool: [n_pages,Hkv,ps,D] through
    [B,P] (entries clamped to the pool) -> [B,P*ps,Hkv,D]."""
    n_pages, Hkv, ps, D = pages.shape
    B, P = page_table.shape
    pt = torch.clamp(page_table.long(), 0, n_pages - 1)
    d = pages[pt]                                   # [B,P,Hkv,ps,D]
    return d.permute(0, 1, 3, 2, 4).reshape(B, P * ps, Hkv, D)


def ref_decode_attention_paged(q, k_pages, v_pages, page_table, pos):
    """Paged oracle: gather each row's pages into a dense [B,S,Hkv,D] view
    and defer to :func:`ref_decode_attention`."""
    return ref_decode_attention(q, gather_pages(k_pages, page_table),
                                gather_pages(v_pages, page_table), pos)


def ref_prefill_attention_paged(q, k_pages, v_pages, page_table, pos):
    """Paged chunked-prefill oracle: dense per-row gather, then defer."""
    return ref_prefill_attention(q, gather_pages(k_pages, page_table),
                                 gather_pages(v_pages, page_table), pos)
