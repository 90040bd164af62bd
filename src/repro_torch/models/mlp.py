"""Feed-forward blocks: SwiGLU (gated), squared-ReLU / GELU (non-gated)."""
from __future__ import annotations

import torch.nn.functional as F

from .common import ACTIVATIONS, dense_init
from ..dist.sharding import Reduced, axes_of, current_mesh, local_call, spec_of


def init_mlp(seed, path, d_model, d_ff, act, dtype, device, lead=()):
    """``lead`` prepends stacked axes (``(n_periods,)`` for the layer
    stack); fan-in stays the per-layer ``d_model`` / ``d_ff``."""
    lead = tuple(lead)

    def w(name, shape):
        return dense_init(seed, f"{path}/{name}", lead + shape, dtype, device,
                          fan_in=shape[0])

    if act == "swiglu":
        return {"w_gate": w("w_gate", (d_model, d_ff)),
                "w_up": w("w_up", (d_model, d_ff)),
                "w_down": w("w_down", (d_ff, d_model))}
    return {"w_up": w("w_up", (d_model, d_ff)),
            "w_down": w("w_down", (d_ff, d_model))}


def mlp_forward(p, x, act: str):
    """The block on ``x`` [..., D]. In a mesh it runs on each rank's
    shards where the reference's compiled program places it: the hidden
    split as ``w_up``'s output dim is (over "model" where it divides),
    ``x`` whole over it, ``w_down``'s partial products summed (one
    all-reduce); the identity placement-wise outside a mesh."""
    if current_mesh() is None:
        return _mlp(p, x, act)
    names = [n for n in ("w_gate", "w_up", "w_down") if n in p]
    hs = spec_of(p["w_up"])[-1]
    xs = spec_of(x)
    specs = [(hs, None) if n == "w_down" else (None, hs) for n in names]
    return local_call(
        lambda x, *w: _mlp(dict(zip(names, w)), x, act), x,
        *(p[n] for n in names), in_specs=[xs] + specs,
        out_specs=[Reduced(xs, axes_of(hs)) if hs else xs])


def _mlp(p, x, act):
    if act == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = ACTIVATIONS["sq_relu" if act == "sq_relu" else "gelu"](
            x @ p["w_up"])
    return h @ p["w_down"]
