"""Linear-recurrence scan (SSD / Mamba2) on Hopper: ``S_t =
diag(exp w_t) S_{t-1} + k_t v_t^T``, ``y_t = q_t . S_t`` (inclusive), with
an f32 ``[K, P]`` state.

CUDA wrapper for ``csrc/ssd_scan.cu``, which replaces the Pallas kernel
``src/repro/kernels/ssd_scan.py::ssd_scan`` with the same arguments and
result. The kernel applies the exact decay exp(s_j - s_i) (every exponent
<= 0, no clamp), so it equals the recurrence of the oracle
``ref.ref_ssd_scan`` everywhere, and the Pallas kernel wherever no chunk's
cumulative log-decay passes the latter's clamp of -20. For the same reason
``chunk`` only has to divide ``T`` (the reference's contract, kept by
:func:`chunk_len`): the kernel walks ``T`` in sub-chunks of 16 tokens
whatever the chunk, so every chunk gives the same bits, and a ragged last
sub-chunk is masked.

What bounds it on the card, and its design: see the source's head. Inputs
are read through their strides (any ``[B,T,H,*]`` view whose last axis is
contiguous, broadcast axes included); ``log_w`` may be f32 beside bf16 or
f16 ``q``, ``k``, ``v`` (as mamba2 computes it). ``K`` is at most 128.

CUDA tensors only; :mod:`repro_torch.kernels.ops` sends CPU tensors to the
plain version. Counts its launches in ``ssd_scan.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import DTYPE_CODES, check_launch, entry, stream_of

MAX_K = 128


def chunk_len(T: int, chunk: int) -> int:
    """The chunk length ``min(chunk, T)``; raises unless it divides T."""
    L = min(chunk, T)
    if L <= 0 or T % L:
        raise ValueError(f"ssd_scan: T={T} is not a multiple of the chunk "
                         f"{L}")
    return L


def ssd_scan(q, k, v, log_w, *, chunk=64):
    """q, k, log_w: [B,T,H,K]; v: [B,T,H,P] -> y [B,T,H,P] in q's dtype."""
    B, T, H, K = q.shape
    P = v.shape[-1]
    L = chunk_len(T, chunk)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"ssd_scan: CUDA kernel called on {dev}")
    if tuple(k.shape) != (B, T, H, K) or tuple(log_w.shape) != (B, T, H, K) \
            or tuple(v.shape[:3]) != (B, T, H):
        raise ValueError(f"ssd_scan: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} log_w "
                         f"{tuple(log_w.shape)}")
    if q.dtype not in DTYPE_CODES or log_w.dtype not in DTYPE_CODES:
        raise ValueError(f"ssd_scan: unsupported dtypes {q.dtype}, "
                         f"{log_w.dtype}")
    for what, t in (("k", k), ("v", v), ("log_w", log_w)):
        if t.device != dev or (what != "log_w" and t.dtype != q.dtype):
            raise ValueError(f"ssd_scan: {what} is {t.dtype} on {t.device}; "
                             f"q is {q.dtype} on {dev}")
    for what, t in (("q", q), ("k", k), ("v", v), ("log_w", log_w)):
        if t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError(f"ssd_scan: {what} needs a contiguous last axis")
    if K > MAX_K:
        raise ValueError(f"ssd_scan: K {K} > {MAX_K}")
    y = torch.empty(B, T, H, P, dtype=q.dtype, device=dev)
    strides = (ctypes.c_int64 * 15)(*(s for t in (q, k, v, log_w, y)
                                      for s in t.stride()[:3]))
    err = entry("ssd_scan")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
        y.data_ptr(), DTYPE_CODES[q.dtype], DTYPE_CODES[log_w.dtype], B, T,
        H, K, P, L, strides, stream_of(dev))
    check_launch("ssd_scan", err)
    ssd_scan.launches += 1
    return y


ssd_scan.launches = 0
