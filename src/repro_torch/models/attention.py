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

In a mesh, attention runs where the reference's compiled program places
it: the reference has no sharding hint in attention and XLA's
propagation keeps every head on every "model" rank (its projections
gather ``wq``/``wk``/``wv`` in training, its decode reduces partial
q/k/v, its ``wo`` products come out split on d_model and are gathered).
The port states those placements (:func:`_whole_heads`,
:func:`_decode_sharded`), so DTensor's propagation never chooses them.

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
from ..dist.sharding import (axes_of, current_mesh, local_call, mesh_gather,
                             mesh_reduce, reshard, spec_of, whole_product)
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
    reference's lowerings (its ``unroll``, which changes no number).
    Where autograd records nothing (no grad, or no input that requires
    it), each block runs :func:`_attend_lean`: at most two block-sized f32
    buffers at once, the same values."""
    B, Sq, H, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    block_q = min(block_q, Sq)
    lean = not _records(q, k, v)
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
        mask = torch.ones((n, hi), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos[:, :hi] <= q_pos
        if window is not None:
            mask &= k_pos[:, :hi] > q_pos - window
        if lean:
            outs.append(_attend_lean(
                qg[:, start:start + n], kh[:, :, :hi], vh[:, :, :hi],
                mask[None, None, None], cap, v.dtype, _BLOCK_EQS))
            continue
        s = torch.einsum(_BLOCK_EQS[0], qg[:, start:start + n].float(),
                         kh[:, :, :hi]) * (Dh ** -0.5)
        if cap is not None:
            s = softcap(s, cap)
        w = _masked_softmax(s, mask[None, None, None])
        outs.append(torch.einsum(_BLOCK_EQS[1], w.to(v.dtype).float(),
                                 vh[:, :, :hi]))
        del s, w                    # one block's scores live at a time
    out = torch.cat(outs, dim=1)
    return out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


# the scores' and P·V's einsums: the blocked loop's (K/V head-major) and
# grouped_attention's (K/V as given, [B,Sk,Hkv,D])
_BLOCK_EQS = ("bqhgd,bhkd->bhgqk", "bhgqk,bhkd->bqhgd")
_GROUP_EQS = ("bqhgd,bkhd->bhgqk", "bhgqk,bkhd->bqhgd")


def _records(*ts) -> bool:
    """Whether autograd records an op on ``ts``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _attend_lean(q, k, v, mask, cap, p_dtype, eqs):
    """Attention of ``q`` over ``k``/``v`` in f32 (each widened where it
    is used, as the recorded path widens it) where autograd records
    nothing: the scores are scaled, capped, masked and softmaxed in place,
    and the f32 weights are freed before their rounding to ``p_dtype``
    (the P·V operand's dtype) is widened, so at most two score-sized f32
    buffers live at once. Each op is the recorded path's on the same
    values (``einsum(...) * scale``, ``softcap``, ``where``,
    ``softmax``, ``w.to(p_dtype).float()``), so the result is bit-equal to
    it."""
    s = torch.einsum(eqs[0], q.float(), k.float()).mul_(
        q.shape[-1] ** -0.5)
    if cap is not None:
        s.div_(cap).tanh_().mul_(cap)
    if mask is not None:
        s.masked_fill_(~mask, NEG_INF)
    torch.softmax(s, dim=-1, out=s)
    if s.dtype != p_dtype:
        p = s.to(p_dtype)
        del s
        s = p.float()
        del p
    return torch.einsum(eqs[1], s, v.float())


def _softmax(scores, mask):
    """The weights of ``scores`` (f32): a softmax over the keys, the
    positions ``mask`` drops (where given) set to NEG_INF first."""
    return (_masked_softmax(scores, mask) if mask is not None
            else torch.softmax(scores, dim=-1))


def _softmax_pv_plain(scores, v, mask):
    """softmax·V as autograd records it op by op (the plain version of
    :class:`_SoftmaxPV`, for the tests and ``chip_smoke.py``): it keeps
    the f32 weights, an f32 copy of their rounding to ``v``'s dtype and
    an f32 copy of ``v`` for the backward pass."""
    w = _softmax(scores, mask)
    return torch.einsum(_GROUP_EQS[1], w.to(v.dtype).float(), v.float())


class _SoftmaxPV(torch.autograd.Function):
    """softmax·V of :func:`_softmax_pv_plain` (scores [B,Hkv,G,Sq,Sk],
    ``v`` [B,Sk,Hkv,D]), keeping the f32 weights once and ``v`` in its own
    dtype for the backward pass (the plain graph keeps the weights and the
    f32 copies of their rounding and of ``v`` that its einsum lays out for
    its ``bmm``). The backward pass lays them out again, rounding the
    weights to ``v``'s dtype for dV, and runs the two ``bmm`` that
    autograd runs for that einsum, rounds dP to ``v``'s dtype, and runs
    the softmax's and the mask's backward, so values and gradients are
    the plain graph's bit for bit. The mask (bool, as given) is held as
    it is."""

    @staticmethod
    def forward(ctx, scores, v, mask):
        w = _softmax(scores, mask)
        ctx.mask = mask
        ctx.save_for_backward(w, v)
        return torch.einsum(_GROUP_EQS[1], w.to(v.dtype).float(), v.float())

    @staticmethod
    def backward(ctx, g):
        w, v = ctx.saved_tensors
        B, Hkv, G, Sq, Sk = w.shape
        D = v.shape[-1]
        # the einsum's operands: [B*Hkv, Sq*G, Sk] weights, [B*Hkv, Sk, D]
        # values, and the output's gradient laid out as its product
        wr = w.to(v.dtype).float().permute(0, 1, 3, 2, 4).reshape(
            B * Hkv, Sq * G, Sk)
        vr = v.float().permute(0, 2, 1, 3).reshape(B * Hkv, Sk, D)
        gr = g.reshape(B, Sq, Hkv, G, D).permute(0, 2, 1, 3, 4).reshape(
            B * Hkv, Sq * G, D)
        dv = wr.transpose(1, 2).bmm(gr).view(B, Hkv, Sk, D).permute(
            0, 2, 1, 3).to(v.dtype)
        del wr
        dw = gr.bmm(vr.transpose(1, 2)).view(B, Hkv, Sq, G, Sk).permute(
            0, 1, 3, 2, 4)
        del vr, gr
        ds = torch._softmax_backward_data(dw.to(v.dtype).float(), w, -1,
                                          w.dtype)
        if ctx.mask is not None:
            ds = torch.where(ctx.mask, ds, 0.0)
        return ds, dv, None


# id(local weight shard) -> its spec, while a sharded decode step runs
# (:func:`_decode_sharded`): its weight products are made whole there
_WSPECS = {}


def _ein(eq, a, w):
    """``torch.einsum(eq, a, w)`` for a weight ``w``; in a sharded decode
    step, on ``w``'s shard made whole (``whole_product``)."""
    spec = _WSPECS.get(id(w))
    if spec is None:
        return torch.einsum(eq, a, w)
    return whole_product(eq, a, w, spec)


def _whole_heads(fn, p, x, cfg, *ctx, **kw):
    """``fn(p, x, *ctx, cfg, **kw)`` (a full-sequence attention block) on
    each rank's local tensors, every head on every rank: ``x`` as it is
    placed (rows over the batch axes), each context tensor of ``ctx``
    (cross-attention's encoder output or image features) on the same
    rows, each weight but ``wo`` gathered whole, ``wo`` split on d_model
    as it is placed; the output, split on d_model as that product leaves
    it, gathered to ``x``'s placement (XLA's placement of the reference's
    attention, self and cross)."""
    names = list(p)
    xs = spec_of(x)
    ds = spec_of(p["wo"])[-1]
    specs = [(None,) * (p[n].dim() - 1) + (ds,) if n == "wo" else ()
             for n in names]
    keys = list(kw)
    n0 = len(ctx) + len(keys)
    out = local_call(
        lambda x, *a: fn(dict(zip(names, a[n0:])), x, *a[:len(ctx)], cfg,
                         **dict(kw, **dict(zip(keys, a[len(ctx):n0])))),
        x, *ctx, *kw.values(), *(p[n] for n in names),
        in_specs=[xs] + [xs[:1]] * len(ctx) + [()] * len(keys) + specs,
        out_specs=[xs[:-1] + (ds,)])
    return reshard(out, xs)


def _masked_softmax(scores, mask):
    scores = torch.where(mask, scores,
                         torch.tensor(NEG_INF, device=scores.device))
    return torch.softmax(scores, dim=-1)


def grouped_attention(q, k, v, mask, cap=None):
    """q: [B,Sq,H,Dh]; k,v: [B,Sk,Hkv,Dh]; mask: [B?,Sq,Sk] or [Sq,Sk] bool.

    Returns [B,Sq,H,Dh]. Grouped (GQA) without repeating KV heads; scores
    and softmax in f32. softmax·V is :class:`_SoftmaxPV` where autograd
    records (the f32 weights kept once), else :func:`_attend_lean`.
    """
    B, Sq, H, Dh = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, Dh)
    if mask is not None:
        if mask.dim() == 2:                    # [Sq,Sk]
            mask = mask[None, None, None]
        elif mask.dim() == 3:                  # [B,Sq,Sk]
            mask = mask[:, None, None]
    if not _records(q, k, v):
        out = _attend_lean(qg, k, v, mask, cap, v.dtype, _GROUP_EQS)
    else:
        scores = torch.einsum(_GROUP_EQS[0], qg.float(),
                              k.float()) * (Dh ** -0.5)
        if cap is not None:
            scores = softcap(scores, cap)
        out = _SoftmaxPV.apply(scores, v, mask)
    return out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def _proj_qkv(p, x, cfg, positions):
    q = _ein("bsd,dhk->bshk", x, p["wq"])
    k = _ein("bsd,dhk->bshk", x, p["wk"])
    v = _ein("bsd,dhk->bshk", x, p["wv"])
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
    if current_mesh() is not None:
        return _whole_heads(gqa_forward, p, x, cfg, layer_kind=layer_kind,
                            positions=positions, causal=causal)
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


def _split_softmax(scores, mask, axes):
    """The softmax of scores whose keys are split over the mesh ``axes``
    (each rank holds a range of them): the row max and the sum of
    exponentials reduced over the ranks (two all-reduces), then each
    rank's weights; ``_masked_softmax`` where ``axes`` is empty."""
    if not axes:
        return _masked_softmax(scores, mask)
    s = torch.where(mask, scores, torch.tensor(NEG_INF, device=scores.device))
    e = torch.exp(s - mesh_reduce(s.amax(dim=-1, keepdim=True), axes, "max"))
    return e / mesh_reduce(e.sum(dim=-1, keepdim=True), axes)


def _decode_core(q, cache_k, cache_v, positions, cfg, layer_kind, x_dtype,
                 *, use_flash=False, k0=0, seq_axes=()):
    """Shared cached-context attention core over a dense KV window.
    q: [B,Sq,H,Dh] (Sq == 1 for decode, a token chunk for chunked prefill);
    cache_{k,v}: [B,Hkv,S,Dh] (KV-major); positions: [B,Sq] — each query row
    attends to cached positions <= its own. ``use_flash`` (on a layer with
    no softcap/local window) takes the decode kernel for one-token rows and
    the chunked-prefill kernel otherwise. In a sharded decode step the
    cache is this rank's keys from position ``k0`` on, split over the mesh
    ``seq_axes``: the softmax and P.V are reduced over them."""
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
    kv_pos = k0 + torch.arange(S, device=q.device)[None, None, :]
    valid = kv_pos <= positions[:, :, None]          # [B, Sq, S]
    if window:
        valid &= kv_pos > positions[:, :, None] - window
    qg = q.reshape(B, Sq, Hkv, G, Dh)
    scores = torch.einsum("bqhgd,bhkd->bhgqk", qg.float(),
                          cache_k.float()) * (Dh ** -0.5)
    if cfg.attn_logit_softcap:
        scores = softcap(scores, cfg.attn_logit_softcap)
    w = _split_softmax(scores, valid[:, None, None], seq_axes)
    out = mesh_reduce(torch.einsum("bhgqk,bhkd->bqhgd",
                                   w.to(cache_v.dtype).float(),
                                   cache_v.float()), seq_axes)
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
    if current_mesh() is not None:
        return _decode_sharded(_gqa_decode_local, p, x, cfg, cache_k,
                               cache_v, pos, layer_kind=layer_kind)
    out = _gqa_decode_local(p, x, cfg, cache_k, cache_v, pos,
                            layer_kind=layer_kind, use_flash=use_flash)
    return out, cache_k, cache_v


def _gqa_decode_local(p, x, cfg, cache_k, cache_v, pos, *, layer_kind,
                      use_flash=False, h0=0, k0=0, head_axes=(),
                      seq_axes=()):
    """:func:`gqa_decode`'s step on one rank's cache: heads [h0, h0 +
    Hkv_local) split over ``head_axes``, keys from ``k0`` on split over
    ``seq_axes`` (the whole cache at 0 outside a mesh). Returns out."""
    B = x.shape[0]
    Hl, Smax = cache_k.shape[1], cache_k.shape[2]
    pos_t = torch.as_tensor(pos, device=x.device)
    positions = pos_t.reshape(-1).expand(B)[:, None]
    q, k, v = _proj_qkv(p, x, cfg, positions)        # k,v: [B,1,Hkv,Dh]
    if head_axes:
        G = q.shape[2] // k.shape[2]
        q = q[:, :, h0 * G:(h0 + Hl) * G]
        k, v = k[:, :, h0:h0 + Hl], v[:, :, h0:h0 + Hl]
    if pos_t.dim() == 0:
        p0 = (pos if isinstance(pos, int) else int(pos_t)) - k0
        if 0 <= p0 < Smax:
            cache_k[:, :, p0] = k[:, 0].to(cache_k.dtype)
            cache_v[:, :, p0] = v[:, 0].to(cache_v.dtype)
    else:
        _chunk_scatter(cache_k, cache_v, k, v, positions[:, 0] - k0)
    out = _decode_core(q, cache_k, cache_v, positions, cfg, layer_kind,
                       x.dtype, use_flash=use_flash, k0=k0,
                       seq_axes=seq_axes)
    out = mesh_gather(out, 2, head_axes)
    return _ein("bshk,hkd->bsd", out, p["wo"])


def _decode_sharded(fn, p, x, cfg, cache_a, cache_b, pos, **kw):
    """A one-token decode step ``fn`` on each rank's local tensors where
    XLA places the reference's: every weight at its own placement, its
    products made whole (partial sums all-reduced, split outputs
    gathered: ``whole_product``), the norm scales gathered whole, the
    cache never moved: written in place where the position is this
    rank's, keys split over the mesh reduce the softmax, heads split are
    gathered after it, latent features split (an MLA cache) sum the
    scores and gather the latent output. ``x`` takes the cache's row
    placement for the step (the reference's rule places an unstacked,
    prefix, layer's cache one dim off, its rows whole: every rank then
    steps every row) and the output goes back to ``x``'s. No gradient is
    taken through it. Returns (out, cache_a, cache_b)."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    names = list(p)
    # products' weights as they are placed; norm scales gathered whole
    wspecs = [spec_of(p[n]) if p[n].dim() > 1 else () for n in names]
    xs, sa, sb = spec_of(x), spec_of(cache_a), spec_of(cache_b)
    offs = [compute_local_shape_and_global_offset(
        c.shape, c.device_mesh, c.placements)[1] for c in (cache_a, cache_b)]
    seq = cache_a.dim() - 2                  # the sequence axis, -2 in all
    if seq == 2:                             # GQA [B, Hkv, S, Dh]
        if sa[3] is not None or sa != sb:
            raise NotImplementedError(f"a GQA cache placed {sa}, {sb}")
        loc = dict(h0=offs[0][1], k0=offs[0][2],
                   head_axes=axes_of(sa[1]), seq_axes=axes_of(sa[2]))
    else:                                    # MLA [B, S, R], [B, S, rope]
        if sa[:2] != sb[:2]:
            raise NotImplementedError(f"MLA caches placed {sa}, {sb}")
        loc = dict(k0=offs[0][1], seq_axes=axes_of(sa[1]),
                   fa=(offs[0][2], axes_of(sa[2])),
                   fb=(offs[1][2], axes_of(sb[2])))
    ca, cb = cache_a.to_local(), cache_b.to_local()
    rows = (sa[0],) + xs[1:]
    pos_arg = pos if isinstance(pos, torch.Tensor) else None

    def run(x, pos_t, *ws):
        for w, spec in zip(ws, wspecs):
            _WSPECS[id(w)] = spec
        try:
            return fn(dict(zip(names, ws)), x, cfg, ca, cb,
                      pos if pos_t is None else pos_t, **kw, **loc)
        finally:
            _WSPECS.clear()

    pos_spec = rows[:1] if pos_arg is not None and pos_arg.dim() else ()
    out = local_call(run, x, pos_arg, *(p[n] for n in names),
                     in_specs=[rows, pos_spec] + wspecs, out_specs=[rows])
    return reshard(out, xs), cache_a, cache_b


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
    ql = rms_norm(_ein("bsd,dr->bsr", x, p["wq_a"]), p["q_ln"],
                  cfg.norm_eps)
    q = _ein("bsr,rhk->bshk", ql, p["wq_b"])
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions,
                        cfg.rope_theta)
    return q_nope, q_rope


def _mla_latent(p, x, cfg, positions):
    m = cfg.mla
    kv = _ein("bsd,dr->bsr", x, p["wkv_a"])
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
    if current_mesh() is not None:
        return _whole_heads(mla_forward, p, x, cfg, positions=positions,
                            causal=causal)
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


def _mla_core(p, x, cfg, q_nope, q_rope, cache_ckv, cache_krope, positions,
              k0=0, seq_axes=(), fa=(0, ()), fb=(0, ())):
    """Absorbed-matmul attention over a dense latent window. cache_ckv:
    [B,S,R]; cache_krope: [B,S,rope]; positions: [B,Sq] — each query row
    attends to latents at positions <= its own. Scores and the latent
    output are f32 products of the (upcast) operands. In a sharded decode
    step the window is this rank's latents from position ``k0`` on, split
    over the mesh ``seq_axes``, and its features from ``fa[0]``/``fb[0]``
    on, split over ``fa[1]``/``fb[1]``: the scores' partial sums are
    reduced over those, the latent output gathered."""
    m = cfg.mla
    Smax = cache_ckv.shape[1]
    q_eff = _ein("bqhk,rhk->bqhr", q_nope, p["wk_b"])
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    s_lat = torch.einsum("bqhr,bsr->bhqs", _feat(q_eff, fa, cache_ckv).float(),
                         cache_ckv.float())
    s_rope = torch.einsum("bqhk,bsk->bhqs",
                          _feat(q_rope, fb, cache_krope).float(),
                          cache_krope.float())
    if fa[1] == fb[1]:
        scores = mesh_reduce(s_lat + s_rope, fa[1]) * scale
    else:
        scores = (mesh_reduce(s_lat, fa[1])
                  + mesh_reduce(s_rope, fb[1])) * scale
    valid = (k0 + torch.arange(Smax, device=x.device)[None, None, :]
             <= positions[:, :, None])[:, None]          # [B,1,Sq,S]
    w = _split_softmax(scores, valid, seq_axes)
    o_latent = mesh_gather(mesh_reduce(torch.einsum(
        "bhqs,bsr->bqhr", w.to(cache_ckv.dtype).float(), cache_ckv.float()),
        seq_axes), 3, fa[1])
    out = _ein("bqhr,rhn->bqhn", o_latent.to(x.dtype), p["wv_b"])
    return _ein("bshk,hkd->bsd", out, p["wo"])


def mla_decode(p, x, cfg, cache_ckv, cache_krope, pos, **_):
    """Absorbed-matmul MLA decode against the compressed latent cache
    (cache_ckv: [B,Smax,R]; cache_krope: [B,Smax,rope]). A scalar ``pos``
    writes every row at ``pos`` when it is in range (the reference's
    guarded ``dynamic_update_slice``), a vector ``pos`` each row at its own
    position, dropping rows out of range: both leave the same cache.
    Returns (out [B,1,D], cache_ckv, cache_krope)."""
    if current_mesh() is not None:
        return _decode_sharded(_mla_decode_local, p, x, cfg, cache_ckv,
                               cache_krope, pos)
    return (_mla_decode_local(p, x, cfg, cache_ckv, cache_krope, pos),
            cache_ckv, cache_krope)


def _mla_decode_local(p, x, cfg, cache_ckv, cache_krope, pos, *, k0=0,
                      seq_axes=(), fa=(0, ()), fb=(0, ())):
    """:func:`mla_decode`'s step on one rank's latents from position
    ``k0`` on (split over ``seq_axes``), the latent and rope features from
    ``fa[0]``, ``fb[0]`` on (split over ``fa[1]``, ``fb[1]``); the whole
    cache outside a mesh. Returns out."""
    B = x.shape[0]
    Smax = cache_ckv.shape[1]
    pos_t = torch.as_tensor(pos, device=x.device)
    positions = pos_t.reshape(-1).expand(B)[:, None]
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    c_kv, k_rope = _mla_latent(p, x, cfg, positions)
    c_kv, k_rope = _feat(c_kv, fa, cache_ckv), _feat(k_rope, fb, cache_krope)
    if pos_t.dim() == 0:
        p0 = (pos if isinstance(pos, int) else int(pos_t)) - k0
        if 0 <= p0 < Smax:
            cache_ckv[:, p0] = c_kv[:, 0].to(cache_ckv.dtype)
            cache_krope[:, p0] = k_rope[:, 0].to(cache_krope.dtype)
    else:
        _chunk_scatter(cache_ckv, cache_krope, c_kv, k_rope,
                       positions[:, 0] - k0)
    return _mla_core(p, x, cfg, q_nope, q_rope, cache_ckv, cache_krope,
                     positions, k0=k0, seq_axes=seq_axes, fa=fa, fb=fb)


def _feat(t, f, cache):
    """``t``'s last dim cut to the range ``cache`` holds when its features
    are split over the mesh (``f`` = (first, axes)); ``t`` as it is
    otherwise."""
    return t[..., f[0]:f[0] + cache.shape[-1]] if f[1] else t


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
    then cast). Above ``BLOCKED_THRESHOLD`` queries it takes the
    query-blocked loop, as self-attention does (one block's scores
    live at a time). In a mesh it runs as self-attention does
    (:func:`_whole_heads`): every head on every rank, ``kv_feats`` on
    ``x``'s rows, the gate whole."""
    if current_mesh() is not None:
        return _whole_heads(cross_attn_forward, p, x, cfg, kv_feats,
                            gated=gated)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    kv = kv_feats.to(x.dtype)
    k = torch.einsum("btd,dhk->bthk", kv, p["wk"])
    v = torch.einsum("btd,dhk->bthk", kv, p["wv"])
    if x.shape[1] > BLOCKED_THRESHOLD:
        out = blocked_attention(q, k, v, causal=False,
                                cap=cfg.attn_logit_softcap)
    else:
        out = grouped_attention(q, k, v, mask=None,
                                cap=cfg.attn_logit_softcap)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    if gated:
        out = torch.tanh(p["gate"].float()).to(out.dtype) * out
    return out
