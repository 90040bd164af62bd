"""Flash attention on Hopper: tiled GQA self-attention, causal or not, with an
optional local window and logit softcap.

CUDA wrapper for ``csrc/flash_attention.cu``. It replaces the Pallas kernel
``src/repro/kernels/flash_attention.py::flash_attention``, with the same
arguments and result: q [B,S,H,D], k/v [B,S,Hkv,D] -> [B,S,H,D]; query s
sees key t when ``t <= s`` (causal) and ``t > s - window``, and ``softcap``
caps the scaled scores as ``c * tanh(s / c)`` before the mask.

What bounds it on the card is operations: 4 * D flops for each visible
(query, key) pair against a few bytes each. Both tile bodies keep one
query tile on chip, stream key tiles past it with an f32 online softmax,
and visit only the key tiles between the tile's first window start and its
causal diagonal. :func:`route` picks the body before the launch:
``"wgmma"`` for bf16 (``csrc/flash_wgmma.cuh``: TMA loads, both products on
the tensor cores with f32 accumulation), ``"simt"`` for f32 and f16
(``csrc/flash_simt.cuh``: register-tiled f32 FMAs on CUDA cores fed by bulk
copies; TF32 would break the f32 tolerance). A launch that fails raises;
nothing retries on the other route. Both bodies copy 16 bytes at a time, so
q, k and v that do not start on a 16-byte boundary are copied first
(``aligned16``). The tiles are the kernel's own, by route and head dim (64,
128 or 256), so ``block_q`` and ``block_k`` are kept for the reference's
signature only, and S need not divide by them.

CUDA tensors only; :mod:`repro_torch.kernels.ops` sends CPU tensors to
:func:`repro_torch.kernels.ref.ref_attention`. The wrapper counts its
launches in ``flash_attention.launches``, and by route in
``flash_attention.routes``.
"""
from __future__ import annotations

import torch

from ._build import (DTYPE_CODES, ROUTES, aligned16, check_cuda,
                     check_launch, count_launch, entry, stream_of)

HEAD_DIMS = (64, 128, 256)


def route(dtype) -> str:
    """The tile body a launch takes: ``"wgmma"`` (tensor cores) for bf16,
    ``"simt"`` (CUDA cores) for f32 and f16. Both take every head dim in
    ``HEAD_DIMS`` (:func:`check_heads` refuses the others)."""
    return "wgmma" if dtype == torch.bfloat16 else "simt"


def check_heads(name, q, k, v):
    """Raise unless q [B,S,H,D] and k, v [B,S,Hkv,D] are heads the flash
    kernels take."""
    B, S, H, D = q.shape
    if k.shape != v.shape or k.dim() != 4 or k.shape[:2] != (B, S) \
            or k.shape[3] != D or H % k.shape[2] or D not in HEAD_DIMS:
        raise ValueError(f"{name}: unsupported shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} (head dim "
                         f"in {HEAD_DIMS}, H a multiple of Hkv)")


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None,
                    block_q=128, block_k=128):
    """q: [B,S,H,D]; k, v: [B,S,Hkv,D] (made contiguous). Returns
    [B,S,H,D] in q's dtype."""
    del block_q, block_k
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be > 0, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"flash_attention: softcap must be > 0, got "
                         f"{softcap}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    dev = check_cuda("flash_attention", {"q": q, "k": k, "v": v}, q.dtype)
    check_heads("flash_attention", q, k, v)
    B, S, H, D = q.shape
    way = route(q.dtype)
    q, k, v = aligned16(q), aligned16(k), aligned16(v)
    out = torch.empty_like(q)
    err = entry("flash_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        DTYPE_CODES[q.dtype], B, S, H, k.shape[2], D, int(bool(causal)),
        0 if window is None else int(window), int(way == "wgmma"),
        float(D ** -0.5), 0.0 if softcap is None else float(softcap),
        stream_of(dev))
    check_launch("flash_attention", err)
    count_launch(flash_attention, way)
    return out


flash_attention.launches = 0
flash_attention.routes = dict.fromkeys(ROUTES, 0)
