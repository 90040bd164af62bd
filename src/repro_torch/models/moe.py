"""Mixture-of-Experts layer (``repro.models.moe`` in PyTorch): top-k
routing, Switch-style capacity dispatch, shared experts, experts stacked on
the leading axis.

The reference's semantics are kept exactly:

- capacity ``C = max(8, ceil8(top_k * T * capacity_factor / E))`` with ``T =
  B * S`` of the call, so an engine's sentinel rows route and take capacity
  like any row;
- priority is k-major, then token order: a slot's position in its expert's
  buffer is the count of earlier slots (in that order) that chose the same
  expert;
- a slot at position ``>= C`` is dropped: it is written to a drop bin (row
  ``C`` of a ``[E, C + 1, D]`` buffer, sliced off before the experts run)
  and read back from the clipped position times a zero gate;
- ``y`` accumulates in f32 over k = 0..K-1 in order, then the shared
  experts, and is cast to the activation dtype;
- routing runs on f32 activations times the router as the caller holds it
  (the reference casts its f32 master router to the activation dtype
  first);
- top-k ties go to the lower expert index (``jax.lax.top_k``'s order): a
  stable descending sort, not ``torch.topk``, whose order on ties is
  unspecified.

No step needs a host sync: the dispatch is one scatter into the buffer
and the combine one gather. :func:`route_plain` and
:func:`moe_forward_plain` compute the same function without sharing code
with it (argmax rounds for the top-k, a per-expert loop for the keep list
and the experts, a per-token sum for the combine), for the tests and the
chip check; nothing on the serving path uses them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .common import dense_init, dense_init_sliced
from ..dist.sharding import (Reduced, axes_of, current_mesh, local_call,
                             reshard, spec_of)
from .mlp import mlp_forward


def init_moe(seed, path, cfg, dtype, device, lead=()):
    """Router (an f32 master leaf, as in the reference), the stacked
    experts ``[.., E, D, F]`` / ``[.., E, F, D]`` and, with
    ``num_shared_experts``, the always-on shared experts of width
    ``num_shared_experts * d_ff_expert``. The expert leaves are drawn one
    ``lead`` slice at a time (see :func:`~.common.dense_init_sliced`)."""
    m, D = cfg.moe, cfg.d_model
    E, Fe = m.num_experts, m.d_ff_expert
    lead = tuple(lead)

    def w(name, shape):
        return dense_init(seed, f"{path}/{name}", lead + shape, dtype, device,
                          fan_in=shape[-2])

    def ex(name, shape):
        return dense_init_sliced(seed, f"{path}/{name}", lead, shape, dtype,
                                 device)

    p = {"router": dense_init(seed, f"{path}/router", lead + (D, E),
                              torch.float32, device, fan_in=D),
         "experts": {"w_gate": ex("w_gate", (E, D, Fe)),
                     "w_up": ex("w_up", (E, D, Fe)),
                     "w_down": ex("w_down", (E, Fe, D))}}
    if m.num_shared_experts:
        Fs = m.num_shared_experts * Fe
        p["shared"] = {"w_gate": w("sh_gate", (D, Fs)),
                       "w_up": w("sh_up", (D, Fs)),
                       "w_down": w("sh_down", (Fs, D))}
    return p


def capacity(m, T: int) -> int:
    """Slots per expert for a call of ``T`` tokens (the reference's
    ``_capacity``)."""
    c = int(m.top_k * T * m.capacity_factor / m.num_experts)
    return max(8, -(-c // 8) * 8)


class Routing(NamedTuple):
    """One call's routing, every slot in k-major order (slot ``k * T + t``
    is token t's k-th choice): ``idx`` expert [K*T], ``gates`` normalized
    gate [K*T] f32, ``pos`` position in the expert's buffer [K*T],
    ``keep`` bool [K*T] (``pos < C``), ``C`` the capacity, ``aux`` the
    reference's aux dict."""
    idx: torch.Tensor
    gates: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    C: int
    aux: dict


def _gates(p, xf, m):
    """Router logits and probabilities in f32, top-k experts (ties to the
    lower index) and their normalized gates, k-major [K*T], and the aux
    losses (z loss, load balance; ``dropped_frac`` is added by the
    caller)."""
    E, K = m.num_experts, m.top_k
    logits = xf.float() @ p["router"].float()                     # [T,E]
    probs = torch.softmax(logits, dim=-1)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = top[:, :K], order[:, :K]                         # [T,K]
    gates = gates / gates.sum(dim=-1, keepdim=True)
    z = torch.logsumexp(logits, dim=-1)
    frac_tokens = F.one_hot(idx[:, 0], E).float().mean(dim=0)
    frac_probs = probs.mean(dim=0)
    aux = {"z_loss": m.router_z_loss * torch.mean(z * z),
           "lb_loss": m.load_balance_loss * E
           * torch.sum(frac_tokens * frac_probs)}
    return idx.t().reshape(-1), gates.t().reshape(-1), aux


def route(p, x, cfg) -> Routing:
    """The routing of :func:`moe_forward` for x [B,S,D]. Positions are one
    cumulative one-hot count over the k-major slots, which equals the
    reference's per-k cumsum plus its running per-expert count."""
    m = cfg.moe
    xf = x.reshape(-1, x.shape[-1])
    idx, gates, aux = _gates(p, xf, m)
    oh = F.one_hot(idx, m.num_experts)                            # [K*T,E]
    pos = (oh.cumsum(dim=0) - 1).gather(1, idx[:, None])[:, 0]
    C = capacity(m, xf.shape[0])
    keep = pos < C
    aux = dict(aux, dropped_frac=1.0 - keep.float().mean())
    return Routing(idx, gates, pos, keep, C, aux)


def moe_forward(p, x, cfg):
    """x: [B,S,D] -> (y [B,S,D], aux) with aux ``z_loss``, ``lb_loss`` and
    ``dropped_frac``.

    In a mesh each step runs on local tensors where the reference's
    compiled program places it (there is no "expert" axis on the
    production meshes, so its ``hint(.., "expert", ..)`` pins nothing):
    the routing sees every token, as without a mesh (the tokens are
    gathered whole; sort, one-hot and cumulative counts are per batch),
    the dispatch buffer and the expert outputs are whole on every rank,
    and each expert product runs on the weights' hidden split as
    ``w_up``'s last dim is, its partial sums reduced (the weights
    gathered whole where that dim is whole: deepseek-v2 splits the
    model dim, as XLA gathers them); the shared experts are
    :func:`mlp_forward`."""
    m = cfg.moe
    B, S, D = x.shape
    T, E, K = B * S, m.num_experts, m.top_k
    xf = x.reshape(T, D)
    r = local_call(lambda router, xs: route({"router": router}, xs, cfg),
                   p["router"], x)
    C = r.C

    # dispatch: a dropped slot lands in bin C, which is sliced off
    def dispatch(xs, idx, pos, keep):
        buf = torch.zeros((E, C + 1, D), dtype=xs.dtype, device=xs.device)
        buf[idx, torch.where(keep, pos, C)] = xs.repeat(K, 1)
        return buf

    def experts(buf, w_gate, w_up, w_down):
        eb = buf[:, :C]
        h = F.silu(torch.bmm(eb, w_gate)) * torch.bmm(eb, w_up)
        return torch.bmm(h, w_down)                                # [E,C,D]

    # combine: y in f32 over k in order, each slot's output gathered at
    # its clipped position times its gate (zero where dropped)
    def combine(eo, idx, pos, gates, keep):
        eo = eo[idx, pos.clamp(0, C - 1)].reshape(K, T, D)
        g = (gates * keep).float().reshape(K, T, 1)
        y = torch.zeros((T, D), dtype=torch.float32, device=eo.device)
        for k in range(K):
            y = y + eo[k].float() * g[k]
        return y

    ex = p["experts"]
    hs = spec_of(ex["w_up"])[-1] if current_mesh() is not None else None
    buf = local_call(dispatch, xf, r.idx, r.pos, r.keep)
    eo = local_call(experts, buf, ex["w_gate"], ex["w_up"], ex["w_down"],
                    in_specs=[(), (None, None, hs), (None, None, hs),
                              (None, hs, None)],
                    out_specs=[Reduced((), axes_of(hs)) if hs else ()])
    y = reshard(local_call(combine, eo, r.idx, r.pos, r.gates, r.keep),
                spec_of(xf))
    if "shared" in p:
        y = y + mlp_forward(p["shared"], xf, "swiglu").float()
    return y.reshape(B, S, D).to(x.dtype), r.aux


# ---------------------------------------------------------------------------
# plain version (tests and the chip check)
# ---------------------------------------------------------------------------

def route_plain(p, x, cfg) -> Routing:
    """The routing written out step by step, sharing no code with
    :func:`route`: K rounds of ``argmax`` (its first maximum, so ties go
    to the lower index) with each chosen expert masked out, the gates
    divided by their sum in k order, each expert's slots ranked in a
    per-expert loop in k-major order (the first C kept), and the aux
    losses from their definitions."""
    m = cfg.moe
    E, K = m.num_experts, m.top_k
    xf = x.reshape(-1, x.shape[-1])
    T = xf.shape[0]
    logits = xf.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    left = probs.clone()
    picks, vals = [], []
    for _ in range(K):
        e = left.argmax(dim=-1)
        picks.append(e)
        vals.append(probs.gather(1, e[:, None])[:, 0])
        left.scatter_(1, e[:, None], -1.0)
    total = vals[0]
    for v in vals[1:]:
        total = total + v
    idx = torch.cat(picks)
    gates = torch.cat([v / total for v in vals])
    C = capacity(m, T)
    pos = torch.empty_like(idx)
    for e in range(E):
        slots = (idx == e).nonzero()[:, 0]
        pos[slots] = torch.arange(len(slots), device=idx.device)
    keep = pos < C
    top = logits.max(dim=-1).values
    z = top + torch.log(torch.exp(logits - top[:, None]).sum(dim=-1))
    first = torch.bincount(picks[0], minlength=E).float() / T
    aux = {"z_loss": m.router_z_loss * (z * z).sum() / T,
           "lb_loss": m.load_balance_loss * E
           * (first * probs.sum(dim=0) / T).sum(),
           "dropped_frac": (~keep).sum().float() / keep.numel()}
    return Routing(idx, gates, pos, keep, C, aux)


def moe_forward_plain(p, x, cfg, routing: Routing | None = None):
    """:func:`moe_forward` computed expert by expert: each expert's kept
    slots run through its own SwiGLU as a plain matrix product, and each
    token's output is the sum, in k order, of its kept slots' outputs
    times their gates (dropped slots contribute nothing), then the shared
    experts. ``routing`` defaults to :func:`route_plain` (a test may pass
    an altered one). Returns (y, aux, routing)."""
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    xf = x.reshape(T, D)
    r = route_plain(p, x, cfg) if routing is None else routing
    ex = p["experts"]
    kept = r.keep.nonzero()[:, 0]                     # k-major order
    tok = kept % T
    eo = torch.zeros((len(kept), D), dtype=x.dtype, device=x.device)
    for e in range(m.num_experts):
        mine = (r.idx[kept] == e).nonzero()[:, 0]
        xs = xf[tok[mine]]
        h = F.silu(xs @ ex["w_gate"][e]) * (xs @ ex["w_up"][e])
        eo[mine] = h @ ex["w_down"][e]
    y = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    y.index_add_(0, tok, eo.float() * r.gates[kept].float()[:, None])
    if "shared" in p:
        sp = p["shared"]
        hs = F.silu(xf @ sp["w_gate"]) * (xf @ sp["w_up"])
        y = y + (hs @ sp["w_down"]).float()
    return y.reshape(B, S, D).to(x.dtype), r.aux, r
