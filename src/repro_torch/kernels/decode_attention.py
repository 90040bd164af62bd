"""Split-K flash-decode on Hopper: one-new-token GQA attention against a KV
cache.

CUDA wrappers for ``csrc/decode_attention.cu``. They replace the Pallas
kernels ``src/repro/kernels/decode_attention.py::decode_attention`` (dense
cache, ``bshd`` or ``bhsd``) and ``::decode_attention_paged`` (page pool
through a per-row page table), with the same arguments and result.

What bounds them on the card is the bytes of K and V read: a decode does
about two flops per cached byte. One decode step is a small grid if each
(row, KV head) walks its keys alone, so the kernel splits each row's keys
into splits of whole pages (:func:`split_plan`) and gives a cluster of up to
8 blocks to each (row, KV head), block c taking splits c, c + 8, ...; the blocks stream K/V through a ring of
16-byte ``cp.async`` loads, and block 0 merges the cluster's partial
softmax states in a fixed order, in the same launch. The plan depends on
the window and the page size only, never on the batch, so a row's result
is the same bits whatever rows share its batch. The kernel reads only each
row's own keys, ``0..min(pos, window-1)``, through the page table for the
pool (no dense gather is made), and takes the caches' strides, so ``bshd``
and ``bhsd`` both run without a copy; a ragged ``Smax`` is masked in the
kernel, nothing is padded.

These wrappers take CUDA tensors only; :mod:`repro_torch.kernels.ops`
sends CPU tensors to the plain versions in :mod:`repro_torch.kernels.ref`.
Each wrapper counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ._build import (DTYPE_CODES, HEAD_DIMS, _i32, check_launch, entry,
                     stream_of)

#: the most keys a split holds (before rounding up to a whole page): a
#: block's keys are a chain of dependent tiles, so short splits spread a row
#: over more blocks
SPLIT_KEYS = 128
#: blocks of one cluster (the portable limit); a window of more than
#: CLUSTER_MAX splits gives each block several
CLUSTER_MAX = 8
#: a dense cache's split is a multiple of this many keys
DENSE_UNIT = 16
#: query heads one block serves (its q and accumulators live in registers)
MAX_HEADS_PER_BLOCK = 8


class SplitPlan(NamedTuple):
    split: int      # keys a split holds
    n_split: int    # splits over the window
    cluster: int    # blocks per (row, KV head); block c takes splits
                    # c, c + cluster, c + 2 * cluster, ...


def split_plan(window: int, page_size: int = 0) -> SplitPlan:
    """How the kernel cuts a window of ``window`` keys (``page_size`` 0 for
    a dense cache): splits of ``window / CLUSTER_MAX`` keys, at most
    ``SPLIT_KEYS``, rounded up to whole pages. A function of the window and
    the page size only: the batch and the rows' positions never change
    it."""
    unit = page_size or DENSE_UNIT
    split = min(SPLIT_KEYS, -(-window // CLUSTER_MAX))
    split = max(unit, -(-split // unit) * unit)
    n_split = max(1, -(-window // split))
    return SplitPlan(split, n_split, min(n_split, CLUSTER_MAX))


def visible_keys(pos: int, window: int) -> int:
    """Keys a row at ``pos`` attends to: ``0..min(pos, window-1)``."""
    return 0 if pos < 0 else min(pos, window - 1) + 1


def block_ranges(plan: SplitPlan, n_keys: int, c: int) -> list:
    """The key ranges ``[lo, hi)`` block ``c`` of a cluster reads, in its
    order, for a row that sees ``n_keys`` keys (the kernel's arithmetic)."""
    return [(s * plan.split, min((s + 1) * plan.split, n_keys))
            for s in range(c, plan.n_split, plan.cluster)
            if s * plan.split < n_keys]


def heads_per_block(G: int) -> int:
    """Query heads a block serves: G rounded up to 1, 2, 4 or 8; a larger
    G takes several blocks per KV head."""
    return min(MAX_HEADS_PER_BLOCK, 1 << max(G - 1, 0).bit_length())


def pos_vector(pos, B, device):
    """Per-row positions as a contiguous int32 [B] tensor on ``device``
    (``pos`` itself when it is one: the kernels only read it)."""
    if isinstance(pos, torch.Tensor) and pos.dtype == torch.int32 \
            and tuple(pos.shape) == (B,) and pos.device == device \
            and pos.is_contiguous():
        return pos
    p = torch.as_tensor(pos, device=device).to(torch.int32).reshape(-1)
    return p.expand(B).contiguous()


def _launch(q, out, k, v, pos, page_table, *, window, page_size):
    """q/out: [B,H,D] (D contiguous); k/v: [X,Hkv,S,D] views whose first
    three axes are (row, KV head, key) for a dense cache or (page, KV head,
    in-page offset) for a pool, key rows 16-byte aligned; pos: int32 [B];
    page_table: int32 [B,P] or None."""
    name = "decode_attention"
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: CUDA kernel called on {dev}")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: unsupported dtype {q.dtype}")
    for t, what in ((out, "out"), (k, "k"), (v, "v")):
        if t.device != dev or t.dtype != q.dtype:
            raise ValueError(f"{name}: {what} is {t.dtype} on {t.device}, "
                             f"q is {q.dtype} on {dev}")
    B, H, D = q.shape
    Hkv = k.shape[1]
    if D not in HEAD_DIMS or k.shape[-1] != D or v.shape != k.shape \
            or H % Hkv:
        raise ValueError(f"{name}: unsupported heads H={H} Hkv={Hkv} D={D}")
    for t, what in ((q, "q"), (out, "out"), (k, "k"), (v, "v")):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: {what} needs a contiguous last axis")
    size = k.element_size()
    for t, what in ((k, "k"), (v, "v")):
        if t.data_ptr() % 16 or any(s * size % 16 for n, s in
                                    zip(t.shape[:-1], t.stride()[:-1])
                                    if n > 1):
            raise ValueError(f"{name}: {what}'s key rows must start on "
                             "16-byte boundaries")
    plan = split_plan(window, page_size)
    pt_ptr, pt_stride, n_pages = None, 0, 0
    if page_table is not None:
        pt_ptr = _i32(page_table, (B, page_table.shape[1]), dev, "page_table")
        pt_stride, n_pages = page_table.shape[1], k.shape[0]
    err = entry(name)(
        q.data_ptr(), out.data_ptr(), k.data_ptr(), v.data_ptr(),
        _i32(pos, (B,), dev, "pos"), pt_ptr, DTYPE_CODES[q.dtype], B, H, Hkv,
        D, heads_per_block(H // Hkv), int(window), int(page_size), pt_stride,
        n_pages, plan.split, plan.cluster, q.stride(0), q.stride(1),
        out.stride(0), out.stride(1), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), float(D ** -0.5),
        stream_of(dev))
    check_launch(name, err)


def decode_attention(q, k_cache, v_cache, pos, *, block_k=128,
                     kv_layout="bshd"):
    """q: [B,H,D]; caches: [B,Smax,Hkv,D] (``"bshd"``) or KV-major
    [B,Hkv,Smax,D] (``"bhsd"``); pos: scalar or [B]. Returns [B,H,D].
    ``block_k`` is kept for the reference's signature; the kernel's key tile
    and split are its own."""
    del block_k
    if kv_layout == "bshd":
        kt, vt = k_cache.transpose(1, 2), v_cache.transpose(1, 2)
    elif kv_layout == "bhsd":
        kt, vt = k_cache, v_cache
    else:
        raise ValueError(f"unknown kv_layout {kv_layout!r}")
    B = q.shape[0]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    _launch(q, out, kt, vt, pos_vector(pos, B, q.device), None,
            window=kt.shape[2], page_size=0)
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
    _launch(q, out, k_pages, v_pages, pos_vector(pos, B, q.device), pt,
            window=pt.shape[1] * ps, page_size=ps)
    decode_attention_paged.launches += 1
    return out


decode_attention.launches = 0
decode_attention_paged.launches = 0
