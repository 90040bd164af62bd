"""Error-feedback int8 gradient compression (``repro.train.compression`` in
PyTorch).

Quantizing a gradient exchange to int8 with error feedback preserves
convergence (the residual is re-injected next step) while cutting the bytes
2x vs bf16 / 4x vs fp32. Wired into the train step as an optional
transform. The reference's cross-pod mean (``compressed_cross_pod_mean``,
an int8 all-gather over the ``pod`` mesh axis) waits on the port's
sharding layer.
"""
from __future__ import annotations

import torch

from .tree import leaves, unflatten


def quantize_int8(x):
    """Per-tensor symmetric int8. Returns (q, scale)."""
    xf = x.float()
    scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q, scale):
    return q.float() * scale


def ef_compress_tree(grads, err):
    """Error-feedback compress: returns (dequantized grads, new_err).
    err carries the quantization residual into the next step."""
    def one(g, e):
        corrected = g.float() + e
        q, s = quantize_int8(corrected)
        deq = dequantize(q, s)
        return deq.to(g.dtype), corrected - deq
    out = [one(g, e) for g, e in zip(leaves(grads), leaves(err))]
    return (unflatten(grads, [o[0] for o in out]),
            unflatten(grads, [o[1] for o in out]))


def init_error_feedback(params):
    return unflatten(params, [torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device)
                              for p in leaves(params)])
