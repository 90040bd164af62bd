"""Dual-tenant fused attention on Hopper: the LS and the BE tenant's causal
flash attentions in one launch, BE's query tiles held to its ``sm_be`` share
of each scheduling round.

CUDA wrapper for ``csrc/dual_tenant_attention.cu``. It replaces the Pallas
kernel ``src/repro/kernels/dual_tenant_attention.py::dual_tenant_attention``
with the same arguments and result: q_* [B*,S,H,D], k_*/v_* [B*,S,Hkv,D]
(the tenants share S, H, Hkv and D; the batches may differ) ->
``(o_ls, o_be)``.

Work units are (tenant, b, h, query tile) in the order of
:func:`repro_torch.kernels.dual_tenant_matmul._schedule` (``sm_be`` and
``round_tiles`` as in the reference), over the kernel's own query tile,
which is also ``flash_attention``'s on the same route
(:func:`repro_torch.kernels.flash_attention.route`: bf16 runs the
tensor-core body with 128-row tiles, f32 and f16 the CUDA-core body with
64-row tiles, a (b, h)'s last tile first), so
``block_q`` and ``block_k`` are kept for the signature only. The wrapper
uploads the order as int32 (owner, row) pairs, cached per shape and quota;
a persistent grid takes units from an atomic ticket in that order. Every unit runs the very tile code of
``flash_attention``, so each output equals ``flash_attention(causal=True)``
on that tenant bit for bit, whatever ``sm_be`` is.

What bounds it on the card is operations, as flash attention.

CUDA tensors only; :mod:`repro_torch.kernels.ops` sends CPU tensors to the
plain version. The wrapper counts its launches in
``dual_tenant_attention.launches``, and by route in
``dual_tenant_attention.routes``.
"""
from __future__ import annotations

import functools

import torch

from ._build import (DTYPE_CODES, ROUTES, aligned16, check_cuda,
                     check_launch, count_launch, entry, stream_of)
from .dual_tenant_matmul import schedule_order
from .flash_attention import check_heads, route


@functools.lru_cache(maxsize=None)
def tile_rows(D: int, way: str) -> int:
    """Query rows of one work unit (the flash kernels' query tile) for head
    dim ``D`` on route ``way``."""
    rows = entry("dual_tenant_attention", "sgdrc_flash_tile_rows")(
        D, int(way == "wgmma"))
    if rows <= 0:
        raise ValueError(f"dual_tenant_attention: unsupported head dim {D}")
    return rows


def dual_tenant_attention(q_ls, k_ls, v_ls, q_be, k_be, v_be, *, sm_be=0.3,
                          block_q=128, block_k=128, round_tiles=8):
    """(causal_attn(q_ls, k_ls, v_ls), causal_attn(q_be, k_be, v_be)) in one
    launch under the BE tile quota. Inputs are made contiguous."""
    del block_q, block_k
    name = "dual_tenant_attention"
    q_ls, k_ls, v_ls, q_be, k_be, v_be = (
        t.contiguous() for t in (q_ls, k_ls, v_ls, q_be, k_be, v_be))
    dev = check_cuda(name, {"q_ls": q_ls, "k_ls": k_ls, "v_ls": v_ls,
                            "q_be": q_be, "k_be": k_be, "v_be": v_be},
                     q_ls.dtype)
    check_heads(name, q_ls, k_ls, v_ls)
    check_heads(name, q_be, k_be, v_be)
    B_ls, S, H, D = q_ls.shape
    B_be, Hkv = q_be.shape[0], k_ls.shape[2]
    if q_be.shape[1:] != q_ls.shape[1:] or k_be.shape[2] != Hkv:
        raise ValueError(f"{name}: tenants must share S, H, Hkv and D: "
                         f"{tuple(q_ls.shape)} {tuple(k_ls.shape)} vs "
                         f"{tuple(q_be.shape)} {tuple(k_be.shape)}")
    way = route(q_ls.dtype)
    q_ls, k_ls, v_ls, q_be, k_be, v_be = (
        aligned16(t) for t in (q_ls, k_ls, v_ls, q_be, k_be, v_be))
    nq = -(-S // tile_rows(D, way))
    order = schedule_order(B_ls * H * nq, B_be * H * nq, float(sm_be),
                           int(round_tiles), dev)
    o_ls, o_be = torch.empty_like(q_ls), torch.empty_like(q_be)
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    err = entry(name)(
        q_ls.data_ptr(), k_ls.data_ptr(), v_ls.data_ptr(), o_ls.data_ptr(),
        q_be.data_ptr(), k_be.data_ptr(), v_be.data_ptr(), o_be.data_ptr(),
        order.data_ptr(), ticket.data_ptr(), DTYPE_CODES[q_ls.dtype], B_ls,
        B_be, S, H, Hkv, D, order.numel() // 2, int(way == "wgmma"),
        float(D ** -0.5), stream_of(dev))
    check_launch(name, err)
    count_launch(dual_tenant_attention, way)
    return o_ls, o_be


dual_tenant_attention.launches = 0
dual_tenant_attention.routes = dict.fromkeys(ROUTES, 0)
