"""Dual-tenant matmul on Hopper: ``(a_ls @ b_ls, a_be @ b_be)`` in one launch,
BE's tile rows held to its ``sm_be`` share of each scheduling round (the
elastic-SM-multiplexing analogue at block granularity, §4, Fig. 8).

CUDA wrapper for ``csrc/dual_tenant_matmul.cu``. It replaces the Pallas
kernel ``src/repro/kernels/dual_tenant_matmul.py::dual_tenant_matmul`` with
the same arguments and result: a_* [M*, K], b_* [K, N] (shared K and N) ->
``(o_ls, o_be)``, accumulated in f32 (never TF32) and cast to each a's
dtype. :func:`_schedule` is the reference's, copied verbatim: it orders the
tile rows of both tenants, and the kernel's persistent blocks start
(tile row, n-block) units in that order. Tile rows are the kernel's own
(128 rows, read from the library), so ``block_m``, ``block_n`` and
``block_k`` are kept for the signature only, and M, N, K need not divide by
them.

What bounds it on the card is operations (2 * M * K * N). The kernel is a
tiled GEMM written out in CUDA, not ``torch.matmul``: the product is the
work the TPU kernel's own body does. :func:`route` picks its body before
the launch: ``"wgmma"`` (tensor cores, TMA-fed) for bf16 whose K and N are
multiples of 8, so that every row stride TMA reads is a multiple of 16
bytes; ``"simt"`` (f32 FMAs on CUDA cores) for f32, f16, and bf16 of any
other K or N. A launch that fails raises; nothing retries on the other
route. :func:`copy_width` picks how wide the ``"simt"`` body's copies are,
also before the launch.

CUDA tensors only; :mod:`repro_torch.kernels.ops` sends CPU tensors to the
plain version. The wrapper counts its launches in
``dual_tenant_matmul.launches``, and by route in
``dual_tenant_matmul.routes``.
"""
from __future__ import annotations

import functools

import torch

from ._build import (DTYPE_CODES, ROUTES, aligned16, check_cuda,
                     check_launch, count_launch, entry, stream_of)

def route(dtype, K: int, N: int) -> str:
    """The GEMM body a launch takes: ``"wgmma"`` for bf16 with K > 0 and K
    and N multiples of 8, ``"simt"`` otherwise."""
    ok = dtype == torch.bfloat16 and K > 0 and K % 8 == 0 and N % 8 == 0
    return "wgmma" if ok else "simt"


def copy_width(itemsize: int, K: int, N: int, *addresses: int) -> int:
    """Bytes each copy of the ``"simt"`` body moves into shared memory: 16
    where ``K * itemsize``, ``N * itemsize`` and every address are multiples
    of 16, else 4 where they are multiples of 4, else ``itemsize`` (plain
    loads of 2-byte types with an odd K or N)."""
    for width in (16, 4):
        if all(x % width == 0 for x in (K * itemsize, N * itemsize,
                                        *addresses)):
            return width
    return itemsize


def _schedule(n_ls: int, n_be: int, sm_be: float, round_tiles: int = 8):
    """Static interleave of LS/BE tile-row ids honoring the BE quota.

    Fractional quotas accumulate as credit across rounds (``sm_be *
    round_tiles < 1`` earns BE roughly one tile every ``1 / (sm_be *
    round_tiles)`` rounds instead of starving until LS drains), and once
    either tenant runs out of tiles the other fills every remaining round —
    a pure-BE tail after LS completes runs at full width (tidal lending),
    it no longer waits for a terminal drain clause."""
    round_tiles = max(int(round_tiles), 2)
    be_frac = max(0.0, min(float(sm_be), (round_tiles - 1) / round_tiles))
    order = []
    i = j = 0
    credit = 0.0
    while i < n_ls and j < n_be:
        # per-round BE quota with carried fractional credit; BE never takes
        # the whole round while LS tiles remain
        credit += be_frac * round_tiles
        be_now = min(int(credit), round_tiles - 1, n_be - j)
        for _ in range(round_tiles - be_now):
            if i < n_ls:
                order.append((0, i))
                i += 1
        for _ in range(be_now):
            order.append((1, j))
            j += 1
            credit -= 1.0
    # interleaved drain: whichever tenant still holds tiles owns every
    # remaining round in full
    while i < n_ls:
        order.append((0, i))
        i += 1
    while j < n_be:
        order.append((1, j))
        j += 1
    return order


@functools.lru_cache(maxsize=64)
def schedule_order(n_ls: int, n_be: int, sm_be: float, round_tiles: int,
                   device: torch.device) -> torch.Tensor:
    """:func:`_schedule`'s (owner, row) pairs as a flat int32 tensor on
    ``device``, as both dual-tenant kernels read it (read-only: the cache
    hands the same tensor to every caller)."""
    order = _schedule(n_ls, n_be, sm_be, round_tiles=round_tiles)
    return torch.tensor(order, dtype=torch.int32).reshape(-1).to(device)


@functools.lru_cache(maxsize=None)
def tile_m() -> int:
    """Rows of one tile row, the unit the schedule orders (128 on both
    routes)."""
    return entry("dual_tenant_matmul", "sgdrc_matmul_tile")()


def dual_tenant_matmul(a_ls, b_ls, a_be, b_be, *, sm_be=0.3, block_m=128,
                       block_n=128, block_k=128):
    """(a_ls @ b_ls, a_be @ b_be) in one launch under the BE tile quota.
    a_*: [M*, K]; b_*: [K, N]; inputs are made contiguous."""
    del block_m, block_n, block_k
    name = "dual_tenant_matmul"
    a_ls, b_ls, a_be, b_be = (t.contiguous() for t in (a_ls, b_ls, a_be,
                                                         b_be))
    dev = check_cuda(name, {"a_ls": a_ls, "b_ls": b_ls, "a_be": a_be,
                            "b_be": b_be}, a_ls.dtype)
    (m_ls, K), (m_be, K_be) = a_ls.shape, a_be.shape
    N = b_ls.shape[1]
    if b_ls.shape != (K, N) or b_be.shape != (K, N) or K_be != K:
        raise ValueError(f"{name}: need a_* [M*, K] and b_* [K, N], got "
                         f"{tuple(a_ls.shape)} {tuple(b_ls.shape)} "
                         f"{tuple(a_be.shape)} {tuple(b_be.shape)}")
    way = route(a_ls.dtype, K, N)
    if way == "wgmma":
        a_ls, b_ls, a_be, b_be = (aligned16(t) for t in (a_ls, b_ls, a_be,
                                                          b_be))
    tm = tile_m()
    order = schedule_order(-(-m_ls // tm), -(-m_be // tm), float(sm_be), 8,
                           dev)
    o_ls = torch.empty(m_ls, N, dtype=a_ls.dtype, device=dev)
    o_be = torch.empty(m_be, N, dtype=a_be.dtype, device=dev)
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    ptrs = [t.data_ptr() for t in (a_ls, b_ls, o_ls, a_be, b_be, o_be)]
    err = entry(name)(
        *ptrs, order.data_ptr(), ticket.data_ptr(), DTYPE_CODES[a_ls.dtype],
        m_ls, m_be, K, N, order.numel() // 2, int(way == "wgmma"),
        copy_width(a_ls.element_size(), K, N, *ptrs), stream_of(dev))
    check_launch(name, err)
    count_launch(dual_tenant_matmul, way)
    return o_ls, o_be


dual_tenant_matmul.launches = 0
dual_tenant_matmul.routes = dict.fromkeys(ROUTES, 0)
