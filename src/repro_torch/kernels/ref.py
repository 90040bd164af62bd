"""Plain PyTorch versions of every kernel (``repro.kernels.ref``).

They are the CPU path of :mod:`repro_torch.kernels.ops` and the yardstick the
CUDA kernels are held against on the card. Scores and softmax run in f32 with
the reference's finite ``NEG_INF``, products accumulate in f32, and outputs
come back in the input dtype. ``ref_ssd_scan`` steps the recurrence token
by token, the exact oracle of the chunked ``ssd_scan`` kernel.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
SCORES_BUDGET = 1 << 28     # f32 score elements ref_attention holds at once


def _attend(q, kr, vr, valid):
    """q: [B,Sq,H,D]; kr/vr: [B,S,H,D] (heads already repeated); valid:
    [B,Sq,S] bool. Returns [B,Sq,H,D] in q's dtype."""
    D = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) * D ** -0.5
    s = torch.where(valid[:, None], s, torch.tensor(NEG_INF, device=s.device))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, vr.float()).to(q.dtype)


def ref_attention(q, k, v, *, causal=True, window=None, softcap=None):
    """Self-attention oracle of ``flash_attention``. q: [B,S,H,D]; k, v:
    [B,S,Hkv,D]. Query s sees key t when ``t <= s`` (causal) and
    ``t > s - window`` (local window); ``softcap`` caps the scaled scores as
    ``c * tanh(s / c)`` before the mask. Queries run in blocks that keep the
    f32 scores within ``SCORES_BUDGET`` elements (at gemma2-9b's S = 8192
    one pass would hold 4 GiB a head group); each row's result is the
    same."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    kr = torch.repeat_interleave(k, G, dim=2).float()
    vr = torch.repeat_interleave(v, G, dim=2).float()
    kp = torch.arange(S, device=q.device)[None, :]
    step = max(1, SCORES_BUDGET // max(1, B * H * S))
    outs = []
    for q0 in range(0, S, step):
        qb = q[:, q0:q0 + step]
        s = torch.einsum("bqhd,bkhd->bhqk", qb.float(), kr) * D ** -0.5
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        qp = torch.arange(q0, q0 + qb.shape[1], device=q.device)[:, None]
        mask = torch.ones(qp.shape[0], S, dtype=torch.bool, device=q.device)
        if causal:
            mask &= kp <= qp
        if window is not None:
            mask &= kp > qp - window
        s = torch.where(mask[None, None], s,
                        torch.tensor(NEG_INF, device=s.device))
        w = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", w, vr).to(q.dtype))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


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


def ref_spt_gather(arena, spt):
    """Logical pages through the shadow page table: ``out[i] =
    arena[spt[i]]``. arena: [n_arena_pages, page_elems]; spt: [n] int."""
    return arena[spt.long()]


def ref_spt_scatter(x, spt, n_arena_pages):
    """Inverse of :func:`ref_spt_gather` into a zeroed arena
    [n_arena_pages, page_elems]; ``spt`` entries must be unique."""
    out = x.new_zeros((n_arena_pages, x.shape[1]))
    out[spt.long()] = x
    return out


def ref_dual_tenant_matmul(a_ls, b_ls, a_be, b_be):
    """(a_ls @ b_ls, a_be @ b_be) in f32, each cast back to its a's dtype.
    On the card the f32 product is exact f32 only with TF32 off
    (``torch.backends.cuda.matmul.allow_tf32 = False``)."""
    f = torch.float32
    return ((a_ls.to(f) @ b_ls.to(f)).to(a_ls.dtype),
            (a_be.to(f) @ b_be.to(f)).to(a_be.dtype))


def ref_ssd_scan(q, k, v, log_w):
    """Naive per-step recurrence (inclusive): ``S_t = exp(log_w_t) * S_{t-1}
    + k_t v_t^T``, ``y_t = q_t . S_t``. q, k, log_w: [B,T,H,K]; v:
    [B,T,H,P] -> y [B,T,H,P]."""
    B, T, H, K = q.shape
    P = v.shape[-1]
    f = torch.float32
    state = torch.zeros(B, H, K, P, dtype=f, device=q.device)
    ys = []
    for t in range(T):
        state = torch.exp(log_w[:, t].to(f))[..., None] * state + \
            torch.einsum("bhk,bhp->bhkp", k[:, t].to(f), v[:, t].to(f))
        ys.append(torch.einsum("bhk,bhkp->bhp", q[:, t].to(f), state))
    return torch.stack(ys, dim=1).to(q.dtype)
