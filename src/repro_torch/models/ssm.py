"""State-space / linear-recurrence blocks (``repro.models.ssm`` in
PyTorch): one chunked linear-attention scan (GLA-style) behind both RWKV6
("Finch", per-channel data-dependent decay + bonus) and Mamba2 (SSD,
scalar-per-head decay), plus one-step decode.

Recurrence (per head, state S in R^{K x P}):
    S_t = diag(w_t) S_t-1 + k_t v_t^T        (w_t = exp(log_w_t) <= 1)
    y_t = q_t . S_t            (inclusive, mamba2)
    y_t = q_t . (S_t-1 + diag(u) k_t v_t^T)  (exclusive + bonus, rwkv6)

Inside a chunk, with s = cumsum(log_w), key i reaches query j through
exp(s_j - s_i), computed as one exponent on the causally masked [L, L]
pairs. Every such exponent is <= 0, as are those of the cross-chunk term
q_j exp(s_j) and the state tail exp(s_L - s_i), so nothing overflows and
no clamp is needed: the result is the exact recurrence. (The reference
splits the decay into exp(s_j) * exp(-s_i) with s clamped to +-20, which
drops real contributions once a chunk's cumulative decay passes -20; where
no clamp bites the two agree up to rounding.)

Tensors keep the reference's layouts: q, k, log_w [B,T,H,K], v [B,T,H,P],
state [B,H,K,P] in f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import dense_init, rms_norm, sq_relu

_F32 = torch.float32


def _chunk_step(state, qc, kc, vc, sc, sq, inclusive, u):
    """One chunk. qc, kc: [B,L,H,K]; vc: [B,L,H,P]; sc: [B,L,H,K]
    cumulative log-decay within the chunk (inclusive of step t); sq: the
    q-side exponent (``sc`` for inclusive scans, the exclusive cumsum
    ``sc - w`` for rwkv-style read-before-decay). All f32; state [B,H,K,P].
    Returns (new_state, y [B,L,H,P])."""
    L = qc.shape[1]
    i = torch.arange(L, device=qc.device)
    mask = ((i[:, None] >= i[None, :]) if inclusive
            else (i[:, None] > i[None, :]))
    # exp(s_j^(q) - s_i) on the masked (query j, key i) pairs, <= 1 there;
    # the other pairs get -inf, whose exp is 0
    diff = sq[:, :, None] - sc[:, None, :]                   # [B,Lj,Li,H,K]
    diff = diff.masked_fill(~mask[None, :, :, None, None], float("-inf"))
    scores = (qc[:, :, None] * kc[:, None, :] * torch.exp(diff)).sum(-1)
    y = torch.einsum("bjih,bihp->bjhp", scores, vc)
    # cross-chunk: q_j exp(s_j) . S_prev
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


def chunked_linear_attn(q, k, v, log_w, *, bonus=None, inclusive=True,
                        chunk=64, initial_state=None):
    """q, k, log_w: [B,T,H,K]; v: [B,T,H,P]. Returns (y [B,T,H,P] in q's
    dtype, S [B,H,K,P] f32). ``T`` must be a multiple of the chunk
    (``min(chunk, T)``); the chunks run in a Python loop, each building its
    own [B,L,L,H,K] decay."""
    B, T, H, K = q.shape
    P = v.shape[-1]
    L = min(chunk, T)
    assert T % L == 0, (T, L)
    qf, kf, vf, wf = (a.to(_F32) for a in (q, k, v, log_w))
    state = (torch.zeros(B, H, K, P, dtype=_F32, device=q.device)
             if initial_state is None else initial_state.to(_F32))
    uf = None if bonus is None else bonus.to(_F32)
    ys = []
    for c0 in range(0, T, L):
        sl = slice(c0, c0 + L)
        wc = wf[:, sl]
        sc = torch.cumsum(wc, dim=1)
        sq = sc if inclusive else sc - wc                  # read-before-decay
        state, y = _chunk_step(state, qf[:, sl], kf[:, sl], vf[:, sl], sc,
                               sq, inclusive, uf)
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
    B, T, D = x.shape
    s = cfg.ssm
    K = s.head_dim
    H = D // K
    xx = _token_shift(x, shift_last)
    mix = p["tm_mix"]
    xr = x + (xx - x) * mix[0]
    xk = x + (xx - x) * mix[1]
    xv = x + (xx - x) * mix[2]
    xw = x + (xx - x) * mix[3]
    xg = x + (xx - x) * mix[4]
    r = (xr @ p["tm_wr"]).reshape(B, T, H, K)
    k = (xk @ p["tm_wk"]).reshape(B, T, H, K)
    v = (xv @ p["tm_wv"]).reshape(B, T, H, K)
    g = F.silu(xg @ p["tm_wg"])
    dw = p["decay_w"]
    w_dd = (torch.tanh(xw @ dw["a"]) @ dw["b"]).reshape(B, T, H, K)
    log_w = -torch.exp(torch.clamp(dw["base"][None, None] + w_dd.to(_F32),
                                   -8.0, 4.0))               # <= 0
    y, new_state = chunked_linear_attn(
        r, k, v, log_w, bonus=p["bonus"], inclusive=False,
        chunk=min(s.chunk, T), initial_state=state)
    yn = rms_norm(y.reshape(B * T * H, K),
                  torch.zeros((K,), dtype=y.dtype, device=y.device),
                  cfg.norm_eps).reshape(B, T, D)
    yn = yn * (1.0 + p["ln_x"].to(_F32)).to(yn.dtype) * g
    return yn @ p["tm_wo"], new_state, x[:, -1:]


def rwkv_channel_mix(p, x, cfg, shift_last=None):
    xx = _token_shift(x, shift_last)
    mix = p["cm_mix"]
    xk = x + (xx - x) * mix[0]
    xr = x + (xx - x) * mix[1]
    k = sq_relu(xk @ p["cm_wk"])
    return torch.sigmoid(xr @ p["cm_wr"]) * (k @ p["cm_wv"]), x[:, -1:]


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
    B, T, D = x.shape
    s = cfg.ssm
    d_in = s.expand * D
    P = s.head_dim
    H = d_in // P
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
    y = rms_norm(y * F.silu(z), p["out_norm"], cfg.norm_eps)
    return y @ p["out_proj"], new_state, new_conv
