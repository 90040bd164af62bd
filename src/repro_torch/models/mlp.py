"""Feed-forward blocks: SwiGLU (gated), squared-ReLU / GELU (non-gated)."""
from __future__ import annotations

import torch.nn.functional as F

from .common import ACTIVATIONS, dense_init


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
    if act == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = ACTIVATIONS["sq_relu" if act == "sq_relu" else "gelu"](
            x @ p["w_up"])
    return h @ p["w_down"]
