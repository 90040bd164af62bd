"""State-space / linear-recurrence blocks (``repro.models.ssm`` in
PyTorch): one chunked linear-attention scan (GLA-style) behind both RWKV6
("Finch", per-channel data-dependent decay + bonus) and Mamba2 (SSD,
scalar-per-head decay), plus one-step decode.

Recurrence (per head, state S in R^{K x P}):
    S_t = diag(w_t) S_t-1 + k_t v_t^T        (w_t = exp(log_w_t) <= 1)
    y_t = q_t . S_t            (inclusive, mamba2)
    y_t = q_t . (S_t-1 + diag(u) k_t v_t^T)  (exclusive + bonus, rwkv6)

Inside a chunk, with s = cumsum(log_w), key i reaches query j through
exp(s_j - s_i). A chunk is cut into sub-chunks of up to ``SUB`` tokens:
within one, the exponent is taken as it stands on the causally masked
[l, l] pairs; from an earlier sub-chunk, it is split through that
sub-chunk's last token e as exp(s_j - s_e) * exp(s_e - s_i). Every such
exponent is <= 0, as are those of the cross-chunk term q_j exp(s_j) and
the state tail exp(s_L - s_i), so nothing overflows and no clamp is
needed: the result is the exact recurrence. (The reference splits the
decay into exp(s_j) * exp(-s_i) with s clamped to +-20, which drops real
contributions once a chunk's cumulative decay passes -20; where no clamp
bites the two agree up to rounding.) No tensor holds two position axes of
a whole chunk with K: the exact pairs are [B, n, l, l, H, K], and where a
gradient is taken each chunk is recomputed in the backward pass, so that
autograd keeps only a chunk's inputs and the state.

Tensors keep the reference's layouts: q, k, log_w [B,T,H,K], v [B,T,H,P],
state [B,H,K,P] in f32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import dense_init, rms_norm, sq_relu, wide
from ..dist.sharding import batch_axes, current_mesh, local_call

_F32 = torch.float32


# the span of the exact pairwise decay: a chunk's sub-chunk
SUB = 16


def _chunk_step(state, qc, kc, vc, wc, inclusive, u):
    """One chunk. qc, kc, wc: [B,L,H,K] (wc the per-token log-decay); vc:
    [B,L,H,P]; all f32; state [B,H,K,P]. ``inclusive``: y_t reads the
    state after step t (mamba2), else before it (rwkv6, with the bonus
    ``u``). The chunk is n sub-chunks of l = gcd(L, SUB) tokens. Key i
    of sub-chunk a reaches query j of sub-chunk b through exp(s_j - s_i):
    within a sub-chunk (a = b) as one exponent on the masked [l, l] pairs;
    across (a < b) as exp(s_j - s_e) * exp(s_e - s_i) through the end e of
    a, each factor <= 1, K contracted in the product to [l, l] blocks.
    Returns (new_state, y [B,L,H,P])."""
    B, L, H, K = qc.shape
    P = vc.shape[-1]
    sub = math.gcd(L, SUB)
    n = L // sub
    sc = torch.cumsum(wc, dim=1)             # inclusive of step t
    sq = sc if inclusive else sc - wc        # the q-side exponent
    q5, k5, v5, s5, sq5 = (t.reshape(B, n, sub, H, t.shape[-1])
                           for t in (qc, kc, vc, sc, sq))
    i = torch.arange(sub, device=qc.device)
    mask = ((i[:, None] >= i[None, :]) if inclusive
            else (i[:, None] > i[None, :]))
    # exp(s_j^(q) - s_i) on the masked (query j, key i) pairs of a
    # sub-chunk, <= 1 there; the other pairs get -inf, whose exp is 0
    diff = sq5[:, :, :, None] - s5[:, :, None, :]           # [B,n,lj,li,H,K]
    diff = diff.masked_fill(~mask[None, None, :, :, None, None],
                            float("-inf"))
    scores = (q5[:, :, :, None] * k5[:, :, None, :] * torch.exp(diff)).sum(-1)
    y = torch.einsum("bnjih,bnihp->bnjhp", scores, v5)
    if n > 1:
        # earlier sub-chunks a < b: the pairs (b, a >= b) get -inf
        se = s5[:, :, -1]                                    # [B,n,H,K]
        a = torch.arange(n, device=qc.device)
        qe = sq5[:, :, None] - se[:, None, :, None]          # [B,nb,na,l,H,K]
        qe = qe.masked_fill(~(a[None, :] < a[:, None])[None, :, :, None, None,
                                                          None],
                            float("-inf"))
        ke = k5 * torch.exp(se[:, :, None] - s5)             # [B,na,l,H,K]
        blocks = torch.einsum("bxajhk,baihk->bxajih",
                              q5[:, :, None] * torch.exp(qe), ke)
        y = y + torch.einsum("bxajih,baihp->bxjhp", blocks, v5)
    y = y.reshape(B, L, H, P)
    # from the state: q_j exp(s_j) . S_prev
    y = y + torch.einsum("blhk,bhkp->blhp", qc * torch.exp(sq), state)
    if u is not None:  # rwkv bonus: diagonal term q_t.(u*k_t) v_t
        diag = torch.einsum("blhk,hk,blhk->blh", qc, u, kc)
        y = y + diag[..., None] * vc
    # state update: S = exp(s_L) S_prev + sum_i k_i exp(s_L - s_i) v_i^T
    s_last = sc[:, -1:]                                       # [B,1,H,K]
    k_tail = kc * torch.exp(s_last - sc)
    new_state = (torch.exp(s_last[:, 0])[..., None] * state
                 + torch.einsum("blhk,blhp->bhkp", k_tail, vc))
    return new_state, y


class _Recomputed(torch.autograd.Function):
    """:func:`_chunk_step` whose backward pass recomputes it from its
    inputs, so that autograd keeps only those (a chunk's q, k, v,
    log-decay and state), not the step's [B, n, l, l, H, K] pairs."""

    @staticmethod
    def forward(ctx, inclusive, u, state, qc, kc, vc, wc):
        ctx.inclusive = inclusive
        ctx.save_for_backward(u, state, qc, kc, vc, wc)
        return _chunk_step(state, qc, kc, vc, wc, inclusive, u)

    @staticmethod
    def backward(ctx, g_state, g_y):
        need = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, need)]
            u, state, qc, kc, vc, wc = ins
            out = _chunk_step(state, qc, kc, vc, wc, ctx.inclusive, u)
        grads = iter(torch.autograd.grad(
            out, [t for t, n in zip(ins, need) if n], (g_state, g_y),
            allow_unused=True))
        return (None,) + tuple(next(grads) if n else None for n in need)


def chunked_linear_attn(q, k, v, log_w, *, bonus=None, inclusive=True,
                        chunk=64, initial_state=None):
    """q, k, log_w: [B,T,H,K]; v: [B,T,H,P]. Returns (y [B,T,H,P] in q's
    dtype, S [B,H,K,P] f32). ``T`` must be a multiple of the chunk
    (``min(chunk, T)``); the chunks run in a Python loop, and where a
    gradient is taken each is recomputed in the backward pass. In a mesh
    each rank scans its own rows and heads (rows over the batch axes,
    heads over "model", where they divide): the scan is independent per
    row and head."""
    mesh = current_mesh()
    if mesh is not None:
        B, H = q.shape[0], q.shape[2]
        bax = batch_axes(mesh)
        nb = 1
        for a in bax:
            nb *= mesh.shape[a]
        b = bax if bax and B % nb == 0 else None
        h = ("model" if "model" in mesh.axis_names
             and H % mesh.shape["model"] == 0 else None)
        seq, st = (b, None, h, None), (b, h, None, None)
        return local_call(
            lambda *a: _scan(*a, inclusive=inclusive, chunk=chunk),
            q, k, v, log_w, bonus, initial_state,
            in_specs=[seq, seq, seq, seq, (h, None), st],
            out_specs=[seq, st])
    return _scan(q, k, v, log_w, bonus, initial_state, inclusive=inclusive,
                 chunk=chunk)


def _scan(q, k, v, log_w, bonus, initial_state, *, inclusive, chunk):
    B, T, H, K = q.shape
    P = v.shape[-1]
    L = min(chunk, T)
    assert T % L == 0, (T, L)
    qf, kf, vf, wf = (a.to(_F32) for a in (q, k, v, log_w))
    state = (torch.zeros(B, H, K, P, dtype=_F32, device=q.device)
             if initial_state is None else initial_state.to(_F32))
    uf = None if bonus is None else bonus.to(_F32)
    recompute = torch.is_grad_enabled() and any(
        a is not None and a.requires_grad
        for a in (qf, kf, vf, wf, state, uf))
    ys = []
    for c0 in range(0, T, L):
        sl = slice(c0, c0 + L)
        ins = (state, qf[:, sl], kf[:, sl], vf[:, sl], wf[:, sl])
        state, y = (_Recomputed.apply(inclusive, uf, *ins) if recompute
                    else _chunk_step(*ins, inclusive, uf))
        ys.append(y)
    y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)
    return y.to(q.dtype), state


def linear_attn_step(q, k, v, log_w, state, *, bonus=None, inclusive=True):
    """Single-token decode. q, k, log_w: [B,H,K]; v: [B,H,P]; state
    [B,H,K,P]. Returns (y [B,H,P] in q's dtype, new state)."""
    qf, kf, vf = q.to(_F32), k.to(_F32), v.to(_F32)
    w = torch.exp(log_w.to(_F32))[..., None]                 # [B,H,K,1]
    kv = torch.einsum("bhk,bhp->bhkp", kf, vf)
    if inclusive:
        state = w * state + kv
        y = torch.einsum("bhk,bhkp->bhp", qf, state)
    else:
        eff = state + (bonus.to(_F32)[None, :, :, None] * kv
                       if bonus is not None else kv * 0)
        y = torch.einsum("bhk,bhkp->bhp", qf, eff)
        state = w * state + kv
    return y.to(q.dtype), state


# ---------------------------------------------------------------------------
# RWKV6 time-mix / channel-mix
# ---------------------------------------------------------------------------

def init_rwkv_block(seed, path, cfg, dtype, device, lead=()):
    """``lead`` prepends stacked axes (``(n_periods,)``); fan-ins stay the
    per-layer ones. ``decay_w.base`` and ``bonus`` are f32, as in the
    reference (``cast_tree`` casts them on use)."""
    D = cfg.d_model
    K = cfg.ssm.head_dim
    H = D // K
    lora = 64
    lead = tuple(lead)

    def w(name, shape, dt=dtype, fan_in=None):
        return dense_init(seed, f"{path}/{name}", lead + shape, dt, device,
                          fan_in=fan_in or shape[-2])

    def zeros(*shape):
        return torch.zeros(lead + shape, dtype=dtype, device=device)

    return {
        "tm_mix": zeros(5, D),                        # r,k,v,w,g static mixes
        "tm_wr": w("tm_wr", (D, D)),
        "tm_wk": w("tm_wk", (D, D)),
        "tm_wv": w("tm_wv", (D, D)),
        "tm_wg": w("tm_wg", (D, D)),
        "tm_wo": w("tm_wo", (D, D)),
        "decay_w": {  # data-dependent decay LoRA (the Finch contribution)
            "base": torch.full(lead + (H, K), -2.0, dtype=_F32,
                               device=device),
            "a": w("dw_a", (D, lora)),
            "b": w("dw_b", (lora, D)),
        },
        # the reference's scale 0.5 is fan_in 4
        "bonus": w("bonus", (H, K), dt=_F32, fan_in=4),
        "ln_x": zeros(D),                         # per-head group norm gamma
        "cm_mix": zeros(2, D),
        "cm_wk": w("cm_wk", (D, cfg.d_ff)),
        "cm_wv": w("cm_wv", (cfg.d_ff, D)),
        "cm_wr": w("cm_wr", (D, D)),
    }


def _token_shift(x, last=None):
    """Shift right by one along T; ``last`` [B,1,D] fills position 0."""
    pad = torch.zeros_like(x[:, :1]) if last is None else last.to(x.dtype)
    return torch.cat([pad, x[:, :-1]], dim=1)


def rwkv_time_mix(p, x, cfg, state=None, shift_last=None):
    """x: [B,T,D]; state: [B,H,K,K] or None. Returns (y, new_state,
    new_shift)."""
    y, new_state, shift = time_mix_heads(p, x, cfg, state, shift_last)
    return y @ p["tm_wo"], new_state, shift


def time_mix_heads(p, x, cfg, state=None, shift_last=None):
    """:func:`rwkv_time_mix` up to its output product: (the gated,
    group-normed heads [B,T,H*K], new_state, new_shift). The heads are
    those the weights hold: in a mesh, a rank's columns of ``tm_wr``,
    ``tm_wk``, ``tm_wv``, ``tm_wg`` and the decay's ``b``, with their rows
    of ``base``, ``bonus`` and ``ln_x`` (``x`` whole)."""
    B, T, D = x.shape
    s = cfg.ssm
    K = s.head_dim
    xx = _token_shift(x, shift_last)
    mix = p["tm_mix"]
    xr = x + (xx - x) * mix[0]
    xk = x + (xx - x) * mix[1]
    xv = x + (xx - x) * mix[2]
    xw = x + (xx - x) * mix[3]
    xg = x + (xx - x) * mix[4]
    r = (xr @ p["tm_wr"]).reshape(B, T, -1, K)
    k = (xk @ p["tm_wk"]).reshape(B, T, -1, K)
    v = (xv @ p["tm_wv"]).reshape(B, T, -1, K)
    g = F.silu(xg @ p["tm_wg"])
    dw = p["decay_w"]
    w_dd = (torch.tanh(xw @ dw["a"]) @ dw["b"]).reshape(B, T, -1, K)
    log_w = -torch.exp(torch.clamp(dw["base"][None, None] + w_dd.to(_F32),
                                   -8.0, 4.0))               # <= 0
    y, new_state = chunked_linear_attn(
        r, k, v, log_w, bonus=p["bonus"], inclusive=False,
        chunk=min(s.chunk, T), initial_state=state)
    H = y.shape[2]
    yn = rms_norm(y.reshape(B * T * H, K),
                  torch.zeros((K,), dtype=y.dtype, device=y.device),
                  cfg.norm_eps).reshape(B, T, H * K)
    yn = yn * (1.0 + p["ln_x"].to(_F32)).to(yn.dtype) * g
    return yn, new_state, x[:, -1:]


def rwkv_channel_mix(p, x, cfg, shift_last=None):
    kv, r, shift = channel_mix_parts(p, x, shift_last)
    return torch.sigmoid(r) * kv, shift


def channel_mix_parts(p, x, shift_last=None):
    """:func:`rwkv_channel_mix`'s two products: (the value ``kv``, the
    receptance before its sigmoid, new_shift). In a mesh, a rank's
    columns of ``cm_wk`` with its rows of ``cm_wv`` give one part of
    ``kv``, its columns of ``cm_wr`` its columns of the receptance."""
    xx = _token_shift(x, shift_last)
    mix = p["cm_mix"]
    xk = x + (xx - x) * mix[0]
    xr = x + (xx - x) * mix[1]
    k = sq_relu(xk @ p["cm_wk"])
    return k @ p["cm_wv"], xr @ p["cm_wr"], x[:, -1:]


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------

def init_mamba2_block(seed, path, cfg, dtype, device, lead=()):
    """``a_log``, ``dt_bias`` and ``d_skip`` are f32, as in the reference."""
    D = cfg.d_model
    s = cfg.ssm
    d_in = s.expand * D
    H = d_in // s.head_dim
    N = s.state_dim
    conv_ch = d_in + 2 * N
    lead = tuple(lead)

    def w(name, shape):
        return dense_init(seed, f"{path}/{name}", lead + shape, dtype, device,
                          fan_in=shape[-2])

    def full(value, shape, dt):
        return torch.full(lead + shape, value, dtype=dt, device=device)

    return {
        "in_proj": w("in_proj", (D, 2 * d_in + 2 * N + H)),
        # fan_in conv_dim: the reference's scale conv_dim ** -0.5
        "conv": w("conv", (s.conv_dim, conv_ch)),
        "a_log": full(0.0, (H,), _F32),
        "dt_bias": full(0.0, (H,), _F32),
        "d_skip": full(1.0, (H,), _F32),
        "out_norm": full(0.0, (d_in,), dtype),
        "out_proj": w("out_proj", (d_in, D)),
    }


def _causal_conv(x, w, conv_state=None):
    """x: [B,T,C]; w: [W,C] depthwise. Returns (y, new_state [B,W-1,C])."""
    W = w.shape[0]
    pad = (torch.zeros(x.shape[0], W - 1, x.shape[-1], dtype=x.dtype,
                       device=x.device)
           if conv_state is None else conv_state.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)
    T = x.shape[1]
    y = xp[:, 0:T] * w[0]
    for i in range(1, W):
        y = y + xp[:, i:i + T] * w[i]
    return y, xp[:, xp.shape[1] - (W - 1):]


def mamba2_block(p, x, cfg, state=None, conv_state=None):
    """x: [B,T,D]; state: [B,H,N,P]. Returns (y, new_state,
    new_conv_state)."""
    g, new_state, new_conv = mamba2_heads(p, x, cfg, state, conv_state)
    y = rms_norm(g, p["out_norm"], cfg.norm_eps)
    return y @ p["out_proj"], new_state, new_conv


def mamba2_heads(p, x, cfg, state=None, conv_state=None):
    """:func:`mamba2_block` up to its gated norm: (the gated heads
    ``y * silu(z)`` [B,T,h*P], new_state [B,h,N,P], new_conv_state
    [B,W-1,h*P+2N]). The heads are those the weights hold, h of
    ``a_log``'s length: ``in_proj``'s columns are z, x (h*P each), B, C
    (N each) and dt (h), ``conv``'s channels x's, then B's and C's. In a
    mesh, a rank's z, x and dt columns and x channels for its heads, and
    B and C whole; with every head, the weights as they are."""
    B, T, D = x.shape
    s = cfg.ssm
    P = s.head_dim
    H = p["a_log"].shape[-1]
    d_in = H * P
    N = s.state_dim
    zxbcdt = x @ p["in_proj"]
    z, xs, Bc, Cc, dt = torch.split(zxbcdt, [d_in, d_in, N, N, H], dim=-1)
    conv_in = torch.cat([xs, Bc, Cc], dim=-1)
    conv_out, new_conv = _causal_conv(conv_in, p["conv"], conv_state)
    conv_out = F.silu(conv_out)
    xs, Bc, Cc = torch.split(conv_out, [d_in, N, N], dim=-1)
    dtf = F.softplus(dt.to(_F32) + p["dt_bias"])                   # [B,T,H]
    log_w = -torch.exp(p["a_log"]) * dtf                           # [B,T,H]
    v = xs.reshape(B, T, H, P) * dtf[..., None].to(xs.dtype)
    q = Cc[:, :, None, :].expand(B, T, H, N)
    k = Bc[:, :, None, :].expand(B, T, H, N)
    log_w_k = log_w[..., None].expand(B, T, H, N)
    y, new_state = chunked_linear_attn(
        q, k, v.to(q.dtype), log_w_k, inclusive=True,
        chunk=min(s.chunk, T), initial_state=state)
    y = y + p["d_skip"][None, None, :, None].to(y.dtype) \
        * xs.reshape(B, T, H, P)
    y = y.reshape(B, T, d_in)
    return y * F.silu(z), new_state, new_conv


def gated_norm_out(g, sq_sum, gamma, w_out, d_in, eps):
    """:func:`mamba2_block`'s gated norm and output product on a rank's
    heads: ``g`` [B,T,h*P] (:func:`mamba2_heads`) normed by ``sq_sum``
    [B,T,1], the sum of squares over all ``d_in`` channels (every rank's
    heads) in the precision :func:`~.common.rms_norm` computes in
    (:func:`~.common.wide`), scaled by its rows of ``gamma`` and
    multiplied by its row block of ``out_proj``: one part of the output,
    whose parts over the heads sum to the whole."""
    out = wide(g) * torch.rsqrt(sq_sum / d_in + eps)
    return (out * (1.0 + gamma.to(out.dtype))).to(g.dtype) @ w_out
