"""Chunked-prefill flash attention on Hopper: an Sq-token prompt chunk per
row attends to its cached-context window.

CUDA wrappers for ``csrc/prefill_attention.cu``. They replace the Pallas
kernels ``src/repro/kernels/prefill_attention.py::prefill_attention`` (dense
KV-major cache) and ``::prefill_attention_paged`` (page pool), with the same
arguments, result and abort/progress protocol: ``abort`` caps, per row, how
many chunk positions may complete (clamped to [0, Sq]); rows at or past the
cap see no key and hold garbage, a row with ``abort == 0`` reads no key at
all, and ``progress = min(abort, Sq)``. The first ``abort`` rows equal a
chunk of exactly ``abort`` tokens bit for bit, and rows ``[a, Sq)`` equal a
chunk that starts at ``pos + a``: both bodies place key tiles at absolute
key positions, never relative to ``pos``, and a tile that holds no key of a
row leaves its softmax state as it was.

What bounds them on the card is operations at the engine's chunk lengths
(4 * D flops per visible (query row, key) pair, shared K/V tiles). Per KV
head the chunk's Sq * G query rows flatten into row units that share every
K/V tile they load, and a unit reads keys only up to the last position its
own rows may see (``pos + min(last row, abort - 1)``), so the causal
triangle and the abort cap both cut work. :func:`route` picks the body
before the launch: ``"wgmma"`` for bf16 and f16 at head dims 64 and 128
(``csrc/prefill_wgmma.cuh``: 128-row units, both products on the tensor
cores, P and the output rounded once to the element type), ``"simt"``
otherwise (``csrc/prefill_simt.cuh``: 64-row units, f32 FMAs on CUDA cores
from register tiles). Both copy q, k and v rows in
16-byte pieces (``cp.async``, bulk copies, vector loads), so every row must
start on a 16-byte boundary. A launch that fails raises; nothing retries on
the other route. The chunk's own K/V must already be in the cache.

CUDA tensors only; :mod:`repro_torch.kernels.ops` sends CPU tensors to the
plain versions. Each wrapper counts its launches in ``<wrapper>.launches``,
and by route in ``<wrapper>.routes``.
"""
from __future__ import annotations

import torch

from ._build import ROUTES, count_launch, launch_attention
from .decode_attention import pos_vector

#: head dims and element types of the tensor-core body
WGMMA_HEAD_DIMS = (64, 128)
WGMMA_DTYPES = (torch.bfloat16, torch.float16)


def route(dtype, D) -> str:
    """The tile body a launch takes: ``"wgmma"`` (tensor cores) for bf16 and
    f16 at head dim 64 or 128, ``"simt"`` (CUDA cores) for f32, and for bf16
    and f16 at head dim 32."""
    return "wgmma" if dtype in WGMMA_DTYPES and D in WGMMA_HEAD_DIMS \
        else "simt"


def _check_rows16(name, tensors):
    """Raise unless every row the kernels copy with 16-byte loads starts on
    a 16-byte boundary: a contiguous last axis, the strides of the other
    axes (those longer than 1) multiples of 16 bytes, the data 16-byte
    aligned."""
    for what, t in tensors.items():
        size = t.element_size()
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
                s * size % 16 for s, n in zip(t.stride()[:-1], t.shape[:-1])
                if n > 1):
            raise ValueError(f"{name}: {what} rows must be 16-byte aligned "
                             f"(strides {t.stride()})")


def _launch(name, fn, q, k, v, pos, abort, **kw):
    """Launch on the route of q's dtype and head dim; returns out, or
    ``(out, progress)`` when ``abort`` is given."""
    B = q.shape[0]
    way = route(q.dtype, q.shape[-1])
    _check_rows16(name, {"q": q, "k": k, "v": v})
    ab = prog = None
    if abort is not None:
        ab = pos_vector(abort, B, q.device)
        prog = torch.empty(B, dtype=torch.int32, device=q.device)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    launch_attention("prefill_attention", q, out, k, v,
                     pos_vector(pos, B, q.device), abort=ab, progress=prog,
                     wgmma=way == "wgmma", **kw)
    count_launch(fn, way)
    return out if abort is None else (out, prog)


def prefill_attention(q, k_cache, v_cache, pos, *, block_k=128, abort=None):
    """q: [B,Sq,H,D]; caches: KV-major [B,Hkv,Smax,D] with the chunk's
    keys/values written; pos: [B] chunk starts. Returns [B,Sq,H,D], or
    ``(out, progress)`` when ``abort`` is given. ``block_k`` is kept for the
    reference's signature; the kernel's key tile is its own."""
    del block_k
    return _launch("prefill_attention", prefill_attention, q, k_cache,
                   v_cache, pos, abort, window=k_cache.shape[2])


def prefill_attention_paged(q, k_pages, v_pages, page_table, pos, *,
                            abort=None):
    """q: [B,Sq,H,D]; {k,v}_pages: [n_pages,Hkv,page_size,D]; page_table:
    [B,P] int32 (entries clamped to the pool; columns past the row's last
    needed page never read); pos: [B] chunk starts. Returns [B,Sq,H,D], or
    ``(out, progress)`` when ``abort`` is given."""
    ps = k_pages.shape[2]
    pt = page_table.to(torch.int32).contiguous()
    return _launch("prefill_attention_paged", prefill_attention_paged, q,
                   k_pages, v_pages, pos, abort, page_table=pt,
                   window=pt.shape[1] * ps, page_size=ps)


prefill_attention.launches = 0
prefill_attention.routes = dict.fromkeys(ROUTES, 0)
prefill_attention_paged.launches = 0
prefill_attention_paged.routes = dict.fromkeys(ROUTES, 0)
