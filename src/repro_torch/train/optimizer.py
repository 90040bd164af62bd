"""AdamW with global-norm clipping and a cosine schedule
(``repro.train.optimizer`` in PyTorch), elementwise as the reference writes
it, with no ``torch.optim`` (whose update order and clipping differ).

The reference's ZeRO-1 specs (``zero1_pspecs``: the optimizer state
sharded over the data axis) wait on the port's sharding layer.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from .tree import leaves, unflatten


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
    count, on the params' device."""
    z = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    flat = leaves(params)
    dev = flat[0].device if flat else "cpu"
    return OptState(unflatten(params, [z(p) for p in flat]),
                    unflatten(params, [z(p) for p in flat]),
                    torch.zeros((), dtype=torch.int32, device=dev))


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
    total = None
    for x in leaves(tree):
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, state: OptState, params, *,
                 donate: bool = False):
    """Returns (new_params, new_state, metrics) with ``grad_norm`` and
    ``lr``. With ``donate`` the params and moments are updated in place
    (the new trees are the tensors given), the counterpart of the
    reference's donated buffers; the values are the same either way."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    count = state.count + 1
    lr = lr_at(cfg, count)
    b1c = 1.0 - cfg.b1 ** count.float()
    b2c = 1.0 - cfg.b2 ** count.float()

    def upd(p, g, m, v):
        g = g.float() * scale
        m_new = cfg.b1 * m + (1 - cfg.b1) * g
        v_new = cfg.b2 * v + (1 - cfg.b2) * g * g
        step = (m_new / b1c) / (torch.sqrt(v_new / b2c) + cfg.eps)
        if p.dim() >= 2:
            step = step + cfg.weight_decay * p.float()
        newp = (p.float() - lr * step).to(p.dtype)
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
