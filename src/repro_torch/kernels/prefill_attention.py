"""Chunked-prefill flash attention on Hopper: an Sq-token prompt chunk per
row attends to its cached-context window.

CUDA wrappers for ``csrc/prefill_attention.cu``. They replace the Pallas
kernels ``src/repro/kernels/prefill_attention.py::prefill_attention`` (dense
KV-major cache) and ``::prefill_attention_paged`` (page pool), with the same
arguments, result and abort/progress protocol: ``abort`` caps, per row, how
many chunk positions may complete (clamped to [0, Sq]); rows at or past the
cap see no key and hold garbage, a row with ``abort == 0`` reads no key at
all, and ``progress = min(abort, Sq)``. The first ``abort`` rows equal a
chunk of exactly ``abort`` tokens.

What bounds them on the card is the bytes of K and V read. The kernel
(``csrc/attention_core.cuh``) flattens the chunk's Sq * G query rows of one
KV head into blocks of 16 rows that share every K/V tile they load, and a
block reads keys only up to the last position its own rows may see
(``pos + min(last row, abort - 1)``), so the causal triangle and the abort
cap both cut traffic. The chunk's own K/V must already be in the cache.

CUDA tensors only; :mod:`repro_torch.kernels.ops` sends CPU tensors to the
plain versions. Each wrapper counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import torch

from ._build import launch_attention
from .decode_attention import pos_vector


def _abort_args(abort, B, device):
    """(abort [B] int32 or None, progress buffer or None)."""
    if abort is None:
        return None, None
    return (pos_vector(abort, B, device),
            torch.empty(B, dtype=torch.int32, device=device))


def prefill_attention(q, k_cache, v_cache, pos, *, block_k=128, abort=None):
    """q: [B,Sq,H,D]; caches: KV-major [B,Hkv,Smax,D] with the chunk's
    keys/values written; pos: [B] chunk starts. Returns [B,Sq,H,D], or
    ``(out, progress)`` when ``abort`` is given. ``block_k`` is kept for the
    reference's signature; the kernel's key tile is its own."""
    del block_k
    B = q.shape[0]
    ab, prog = _abort_args(abort, B, q.device)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    launch_attention("prefill_attention", q, out, k_cache, v_cache,
                     pos_vector(pos, B, q.device), abort=ab, progress=prog,
                     window=k_cache.shape[2])
    prefill_attention.launches += 1
    return out if abort is None else (out, prog)


def prefill_attention_paged(q, k_pages, v_pages, page_table, pos, *,
                            abort=None):
    """q: [B,Sq,H,D]; {k,v}_pages: [n_pages,Hkv,page_size,D]; page_table:
    [B,P] int32 (entries clamped to the pool; columns past the row's last
    needed page never read); pos: [B] chunk starts. Returns [B,Sq,H,D], or
    ``(out, progress)`` when ``abort`` is given."""
    B = q.shape[0]
    ps = k_pages.shape[2]
    pt = page_table.to(torch.int32).contiguous()
    ab, prog = _abort_args(abort, B, q.device)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    launch_attention("prefill_attention", q, out, k_pages, v_pages,
                     pos_vector(pos, B, q.device), abort=ab, progress=prog,
                     page_table=pt, window=pt.shape[1] * ps, page_size=ps)
    prefill_attention_paged.launches += 1
    return out if abort is None else (out, prog)


prefill_attention.launches = 0
prefill_attention_paged.launches = 0
