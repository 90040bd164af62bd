"""Error-feedback int8 gradient compression (``repro.train.compression`` in
PyTorch).

Quantizing a gradient exchange to int8 with error feedback preserves
convergence (the residual is re-injected next step) while cutting the bytes
2x vs bf16 / 4x vs fp32. Wired into the train step as an optional
transform; ``compressed_cross_pod_mean`` is the cross-pod exchange itself,
an int8 all-gather over the mesh's ``pod`` axis.
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


def compressed_cross_pod_mean(grads, axis_name: str = "pod", mesh=None):
    """The reference's ``shard_map`` body on each rank: each leaf of
    ``grads`` (this rank's own tensor) is quantized to int8, the values and
    the scales are all-gathered over the ranks of ``mesh``'s ``axis_name``
    dim that share this rank's other coordinates, and their dequantized
    mean is taken in f32 (then cast to the leaf's dtype). ``mesh`` defaults
    to the current one. Cross-pod bytes: n*size_int8 per device vs
    2*size_bf16 for a ring all-reduce — a 4x cut at 2 pods."""
    import torch.distributed._functional_collectives as funcol
    from ..dist.sharding import current_mesh
    mesh = mesh if mesh is not None else current_mesh()
    group = (mesh.device_mesh, mesh.axis_names.index(axis_name))

    def one(g):
        q, s = quantize_int8(g)
        qs = funcol.all_gather_tensor(q[None], 0, group)     # [n, ...] int8
        ss = funcol.all_gather_tensor(s.reshape(1), 0, group)
        return torch.mean(qs.float() * ss.reshape((-1,) + (1,) * g.dim()),
                          dim=0).to(g.dtype)
    return unflatten(grads, [one(g) for g in leaves(grads)])
