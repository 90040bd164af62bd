"""Plain float32 forward of the dense decoders the benchmark serves
(qwen3-1.7b, stablelm-1.6b, nemotron-4-15b), written from their
published descriptions as the program's configurations state them.

A model is its ``arch`` dict (``configs/<config>.json``) and its weights, a
dict of tensors in the layout the benchmark makes them (``weights.py``):
``embed`` [V, D], ``final_ln`` [D], ``unembed`` [D, V] unless the head is
tied, and under ``layers/s0`` one tensor per leaf with the layers stacked
first: ``ln1``, ``ln2`` [L, D]; ``attn/wq`` [L, D, H, Dh], ``wk``, ``wv``
[L, D, Hkv, Dh], ``wo`` [L, H, Dh, D], ``q_gamma``, ``k_gamma`` [L, Dh]
with qk-norm; ``mlp/w_gate``, ``w_up`` [L, D, F], ``w_down`` [L, F, D].

Each layer: x += o(attn(rms(x))); x += mlp(rms(x)); then the head on
rms(x). Where the configuration departs from the published model, so
does this file, and the configuration's ``departures`` list says how:
every norm is RMSNorm with scale (1 + gamma) and eps ``norm_eps``
(stablelm-2 and nemotron-4 publish LayerNorm with a bias); rotary
embedding over the whole head, split halves (stablelm-2 publishes 25% of
it); no bias anywhere (stablelm-2 publishes q, k, v biases); the MLP is
SwiGLU (qwen3, stablelm-2) or squared ReLU (nemotron-4), as published.

Everything runs in float32 with TF32 off (``float32`` precision). The
control's precision, ``float8``, rounds both operands of every matrix
product, attention's included, to float8 e4m3 with scales that factor out
of the product (rows of the left operand, columns of the right), the
finest recipe a lower-precision path would take.

The work goes layer by layer over every sequence given, one layer's
weights in float32 at a time, and attention by blocks of queries, so that
a 15 B model's reference fits beside its bf16 weights.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

E4M3_MAX = 448.0


def _q8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (the amax of the slice maps to e4m3's largest value)."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Precision:
    """The arithmetic of the reference's products: ``float32`` or the
    control's ``float8``."""

    def __init__(self, name: str):
        if name not in ("float32", "float8"):
            raise ValueError(f"unknown precision {name!r}")
        self.fp8 = name == "float8"

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a [..., K] @ b [K, N]."""
        if self.fp8:
            a, b = _q8(a, -1), _q8(b, 0)
        return a @ b

    def bmm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a [G, M, K] @ b [G, K, N]."""
        if self.fp8:
            a, b = _q8(a, -1), _q8(b, -2)
        return torch.bmm(a, b)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * (1.0 + gamma.float())


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [S, H, Dh] at positions 0..S-1: the halves of each head rotated
    (not interleaved), angles in float32."""
    S, _, Dh = x.shape
    half = Dh // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                       device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * inv[None]
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, pr: Precision, block: int = 512):
    """q [S, H, Dh], k, v [S, Hkv, Dh]: each query attends to keys at or
    before its position; returns [S, H, Dh]."""
    S, H, Dh = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    kh = k.permute(1, 2, 0)                       # [Hkv, Dh, S]
    vh = v.permute(1, 0, 2)                       # [Hkv, S, Dh]
    out = torch.empty_like(q)
    for s0 in range(0, S, block):
        s1 = min(s0 + block, S)
        qb = q[s0:s1].reshape(s1 - s0, Hkv, G, Dh).permute(1, 2, 0, 3) \
            .reshape(Hkv, G * (s1 - s0), Dh)
        scores = pr.bmm(qb, kh[:, :, :s1]) / math.sqrt(Dh)
        scores = scores.reshape(Hkv, G, s1 - s0, s1)
        qpos = torch.arange(s0, s1, device=q.device)[:, None]
        kpos = torch.arange(s1, device=q.device)[None]
        scores = scores.masked_fill(kpos > qpos, float("-inf"))
        w = torch.softmax(scores, dim=-1).reshape(Hkv, G * (s1 - s0), s1)
        o = pr.bmm(w, vh[:, :s1])                 # [Hkv, G*n, Dh]
        out[s0:s1] = o.reshape(Hkv, G, s1 - s0, Dh).permute(2, 0, 1, 3) \
            .reshape(s1 - s0, H, Dh)
    return out


def _layer(x, w: Dict[str, torch.Tensor], arch: dict, pr: Precision):
    D, H, Hkv, Dh = (arch["d_model"], arch["num_heads"],
                     arch["num_kv_heads"], arch["head_dim"])
    eps = arch["norm_eps"]
    S = x.shape[0]
    h = rms_norm(x, w["ln1"], eps)
    q = pr.mm(h, w["wq"].reshape(D, H * Dh)).reshape(S, H, Dh)
    k = pr.mm(h, w["wk"].reshape(D, Hkv * Dh)).reshape(S, Hkv, Dh)
    v = pr.mm(h, w["wv"].reshape(D, Hkv * Dh)).reshape(S, Hkv, Dh)
    if arch["qk_norm"]:
        q = rms_norm(q, w["q_gamma"], eps)
        k = rms_norm(k, w["k_gamma"], eps)
    q, k = rope(q, arch["rope_theta"]), rope(k, arch["rope_theta"])
    o = causal_attention(q, k, v, pr)
    x = x + pr.mm(o.reshape(S, H * Dh), w["wo"].reshape(H * Dh, D))
    h = rms_norm(x, w["ln2"], eps)
    if arch["mlp_act"] == "swiglu":
        a = torch.nn.functional.silu(pr.mm(h, w["w_gate"])) \
            * pr.mm(h, w["w_up"])
    elif arch["mlp_act"] == "sq_relu":
        a = torch.relu(pr.mm(h, w["w_up"])) ** 2
    else:
        raise ValueError(f"unknown mlp_act {arch['mlp_act']!r}")
    return x + pr.mm(a, w["w_down"])


def _layer_weights(weights, i: int) -> Dict[str, torch.Tensor]:
    lw = weights["layers"]["s0"]
    out = {"ln1": lw["ln1"][i], "ln2": lw["ln2"][i]}
    for name, t in lw["attn"].items():
        out[name] = t[i]
    for name, t in lw["mlp"].items():
        out[name] = t[i]
    return {k: v.float() for k, v in out.items()}


@torch.no_grad()
def logits_at(weights, arch: dict, seqs: Sequence[torch.Tensor],
              at: Sequence[Sequence[int]], precision: str = "float32") \
        -> List[torch.Tensor]:
    """For each token sequence ``seqs[i]`` (int, on the weights' device),
    the float32 logits [len(at[i]), V] at its positions ``at[i]``."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        pr = Precision(precision)
        embed = weights["embed"]
        xs = [embed[s.long()].float() for s in seqs]
        for i in range(arch["num_layers"]):
            w = _layer_weights(weights, i)
            xs = [_layer(x, w, arch, pr) for x in xs]
            del w
        head = (embed.t() if arch["tie_embeddings"]
                else weights["unembed"]).float()
        out = []
        for x, pos in zip(xs, at):
            h = rms_norm(x[list(pos)], weights["final_ln"], arch["norm_eps"])
            out.append(pr.mm(h, head))
        return out
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
