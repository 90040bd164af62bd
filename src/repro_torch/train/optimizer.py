"""AdamW with global-norm clipping and a cosine schedule
(``repro.train.optimizer`` in PyTorch), elementwise as the reference writes
it, with no ``torch.optim`` (whose update order and clipping differ).

``zero1_pspecs`` is the reference's ZeRO-1 rule, verbatim: the optimizer
state sharded over the data axis as well. On DTensors (a sharded trainer)
the update is the same elementwise code on each rank's shard; the global
norm's sum of squares is a ``Partial`` sum that becomes the full norm, on
every rank, before the clip.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from .tree import leaves, unflatten
from ..dist.sharding import PSpec, move, param_pspecs, reduced_out


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    m: object
    v: object
    count: torch.Tensor


def init_opt_state(params) -> OptState:
    """f32 first and second moments shaped as the params, an int32 step
    count, on the params' device (placed as the params where they are
    DTensors; a sharded trainer re-places them by ``zero1_pspecs``)."""
    z = lambda p: torch.zeros_like(p, dtype=torch.float32)
    flat = leaves(params)
    dev = _local(flat[0]).device if flat else "cpu"
    return OptState(unflatten(params, [z(p) for p in flat]),
                    unflatten(params, [z(p) for p in flat]),
                    torch.zeros((), dtype=torch.int32, device=dev))


def _local(x):
    return x.to_local() if hasattr(x, "to_local") else x


def lr_at(cfg: AdamWConfig, step):
    """Linear warmup to ``lr``, then a cosine down to ``min_lr_frac * lr``
    at ``total_steps`` (f32)."""
    step = step.float()
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac * cfg.lr + (1 - cfg.min_lr_frac) * cfg.lr * 0.5 * (
        1.0 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree):
    """The f32 2-norm of all leaves. DTensor leaves' sums of squares are
    their shards', added up by the mesh dims that split them and summed
    over those (one all-reduce a mesh dim and group, one at a time:
    ``dist.sharding.reduced_out``), so the norm is a plain tensor holding
    the whole tree's norm on every rank."""
    total, split = None, {}
    for x in leaves(tree):
        if hasattr(x, "placements"):
            from torch.distributed.tensor import Replicate
            x = move(x, [Replicate() if p.is_partial() else p
                         for p in x.placements])
            sq = torch.sum(torch.square(x.to_local().float()))
            key = (x.device_mesh, tuple(p.is_shard() for p in x.placements))
            split[key] = sq if key not in split else split[key] + sq
            continue
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    for (dm, dims), sq in split.items():
        from torch.distributed.tensor import Partial, Replicate
        sq = reduced_out(sq, dm, [Partial() if d else Replicate()
                                  for d in dims]).to_local()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, state: OptState, params, *,
                 donate: bool = False):
    """Returns (new_params, new_state, metrics) with ``grad_norm`` and
    ``lr``. With ``donate`` the params and moments are updated in place
    (the new trees are the tensors given), the counterpart of the
    reference's donated buffers; the values are the same either way."""
    if any(hasattr(m, "placements") for m in leaves(state.m)):
        # the gradients reduced onto the moments' (ZeRO-1) shards first,
        # one mesh dim at a time, and the norm taken there
        grads = unflatten(grads, [move(g, m.placements) for g, m in
                                  zip(leaves(grads), leaves(state.m))])
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    count = state.count + 1
    lr = lr_at(cfg, count)
    b1c = 1.0 - cfg.b1 ** count.float()
    b2c = 1.0 - cfg.b2 ** count.float()

    def upd(p, g, m, v):
        pw = p
        if hasattr(m, "placements"):
            # DTensors: the param cut to the moments' (ZeRO-1) shards (the
            # gradient is there already), the update made there, the new
            # param gathered back to its own placements
            pw = move(p, m.placements)
        g = g.float() * scale
        m_new = cfg.b1 * m + (1 - cfg.b1) * g
        v_new = cfg.b2 * v + (1 - cfg.b2) * g * g
        step = (m_new / b1c) / (torch.sqrt(v_new / b2c) + cfg.eps)
        if p.dim() >= 2:
            step = step + cfg.weight_decay * pw.float()
        newp = (pw.float() - lr * step).to(p.dtype)
        if pw is not p:
            newp = move(newp, p.placements)
        if not donate:
            return newp, m_new, v_new
        p.copy_(newp)
        m.copy_(m_new)
        v.copy_(v_new)
        return p, m, v

    out = [upd(p, g, m, v) for p, g, m, v in
           zip(leaves(params), leaves(grads), leaves(state.m),
               leaves(state.v))]
    new_p = unflatten(params, [o[0] for o in out])
    new_m = unflatten(params, [o[1] for o in out])
    new_v = unflatten(params, [o[2] for o in out])
    return new_p, OptState(new_m, new_v, count), {"grad_norm": gnorm,
                                                  "lr": lr}


# ---------------------------------------------------------------------------
# ZeRO-1 sharding
# ---------------------------------------------------------------------------

def zero1_pspecs(params, mesh, enabled: bool = True):
    """Opt-state m/v shardings: the param's spec, plus the data axis on the
    largest still-replicated dim (ZeRO-1). Falls back to the param spec when
    nothing divides."""
    base = param_pspecs(params, mesh)
    if not enabled or "data" not in mesh.axis_names:
        return OptState(base, base, PSpec(mesh, ()))
    dsize = mesh.shape["data"]

    def widen(leaf, sh):
        spec = list(sh.spec) + [None] * (len(leaf.shape) - len(sh.spec))
        order = sorted(range(len(leaf.shape)), key=lambda i: -leaf.shape[i])
        for i in order:
            if spec[i] is None and leaf.shape[i] % dsize == 0 and leaf.shape[i] >= dsize:
                spec[i] = "data"
                break
        return PSpec(mesh, spec)

    mv = unflatten(params, [widen(p, sh) for p, sh in
                            zip(leaves(params), leaves(base))])
    return OptState(mv, mv, PSpec(mesh, ()))