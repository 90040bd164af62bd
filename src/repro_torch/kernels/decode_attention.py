"""Flash-decode on Hopper: one-new-token GQA attention against a KV cache.

CUDA wrappers for ``csrc/decode_attention.cu``. They replace the Pallas
kernels ``src/repro/kernels/decode_attention.py::decode_attention`` (dense
cache, ``bshd`` or ``bhsd``) and ``::decode_attention_paged`` (page pool
through a per-row page table), with the same arguments and result.

What bounds them on the card is the bytes of K and V read: a decode does
about two flops per cached byte. The kernel (``csrc/attention_core.cuh``)
reads only each row's own keys, ``0..min(pos, window-1)``, through the page
table for the pool (no dense gather is made), loads each K/V tile once into
shared memory for all G query heads of a KV head, and takes the caches'
strides, so ``bshd`` and ``bhsd`` both run without a copy. A ragged
``Smax`` is masked in the kernel; nothing is padded.

These wrappers take CUDA tensors only; :mod:`repro_torch.kernels.ops`
sends CPU tensors to the plain versions in :mod:`repro_torch.kernels.ref`.
Each wrapper counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import torch

from ._build import launch_attention


def pos_vector(pos, B, device):
    """Per-row positions as a contiguous int32 [B] tensor on ``device``."""
    p = torch.as_tensor(pos, device=device).to(torch.int32).reshape(-1)
    return p.expand(B).contiguous()


def decode_attention(q, k_cache, v_cache, pos, *, block_k=128,
                     kv_layout="bshd"):
    """q: [B,H,D]; caches: [B,Smax,Hkv,D] (``"bshd"``) or KV-major
    [B,Hkv,Smax,D] (``"bhsd"``); pos: scalar or [B]. Returns [B,H,D].
    ``block_k`` is kept for the reference's signature; the kernel's key tile
    is its own."""
    del block_k
    if kv_layout == "bshd":
        kt, vt = k_cache.transpose(1, 2), v_cache.transpose(1, 2)
    elif kv_layout == "bhsd":
        kt, vt = k_cache, v_cache
    else:
        raise ValueError(f"unknown kv_layout {kv_layout!r}")
    B = q.shape[0]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    launch_attention("decode_attention", q[:, None], out[:, None], kt, vt,
                     pos_vector(pos, B, q.device), window=kt.shape[2])
    decode_attention.launches += 1
    return out


def decode_attention_paged(q, k_pages, v_pages, page_table, pos):
    """q: [B,H,D]; {k,v}_pages: [n_pages,Hkv,page_size,D]; page_table: [B,P]
    int32 (entries outside [0, n_pages) are clamped and, past the row's last
    page, never read); pos: [B]. The visible window is P * page_size
    tokens. Returns [B,H,D]."""
    B = q.shape[0]
    ps = k_pages.shape[2]
    pt = page_table.to(torch.int32).contiguous()
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    launch_attention("decode_attention", q[:, None], out[:, None], k_pages,
                     v_pages, pos_vector(pos, B, q.device), page_table=pt,
                     window=pt.shape[1] * ps, page_size=ps)
    decode_attention_paged.launches += 1
    return out


decode_attention.launches = 0
decode_attention_paged.launches = 0
