"""The kernel layer's public API (``repro.kernels.ops``): each entry point
takes the reference's arguments and runs the plain PyTorch version
(:mod:`.ref`) for CPU tensors, the CUDA kernel for CUDA tensors.

A CUDA tensor always launches its kernel, and a kernel that cannot run
raises: there is no fallback to the plain version. The CPU path exists for
tests and hosts without a card; it is the plain version only because the
tensor it was given lies on the CPU.
"""
from __future__ import annotations

import torch

from . import decode_attention as _decode
from . import dual_tenant_attention as _dta
from . import dual_tenant_matmul as _dtm
from . import flash_attention as _flash
from . import prefill_attention as _prefill
from . import ref
from . import spt_gather as _spt
from . import ssd_scan as _ssd

#: every kernel wrapper, by name; each counts its launches in ``.launches``
KERNELS = {
    "decode_attention": _decode.decode_attention,
    "decode_attention_paged": _decode.decode_attention_paged,
    "prefill_attention": _prefill.prefill_attention,
    "prefill_attention_paged": _prefill.prefill_attention_paged,
    "flash_attention": _flash.flash_attention,
    "dual_tenant_attention": _dta.dual_tenant_attention,
    "dual_tenant_matmul": _dtm.dual_tenant_matmul,
    "spt_gather": _spt.spt_gather,
    "spt_scatter": _spt.spt_scatter,
    "ssd_scan": _ssd.ssd_scan,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def route_counts() -> dict:
    """Launches by route (``"wgmma"`` or ``"simt"``) of the wrappers that
    have two tile bodies."""
    return {name: dict(fn.routes) for name, fn in KERNELS.items()
            if hasattr(fn, "routes")}


def reset_launch_counts():
    for fn in KERNELS.values():
        fn.launches = 0
        if hasattr(fn, "routes"):
            fn.routes = dict.fromkeys(fn.routes, 0)


def _on_cpu(t) -> bool:
    return t.device.type == "cpu"


def _with_progress(out, abort, B, Sq):
    if abort is None:
        return out
    prog = torch.as_tensor(abort, device=out.device).to(torch.int32)
    return out, torch.clamp(prog.reshape(-1).expand(B), 0, Sq).contiguous()


def decode_attention(q, k_cache, v_cache, pos, *, block_k=128,
                     kv_layout="bshd"):
    if not _on_cpu(q):
        return _decode.decode_attention(q, k_cache, v_cache, pos,
                                        block_k=block_k, kv_layout=kv_layout)
    if kv_layout == "bhsd":
        k_cache, v_cache = k_cache.transpose(1, 2), v_cache.transpose(1, 2)
    elif kv_layout != "bshd":
        raise ValueError(f"unknown kv_layout {kv_layout!r}")
    return ref.ref_decode_attention(q, k_cache, v_cache, pos)


def decode_attention_paged(q, k_pages, v_pages, page_table, pos):
    if not _on_cpu(q):
        return _decode.decode_attention_paged(q, k_pages, v_pages,
                                              page_table, pos)
    return ref.ref_decode_attention_paged(q, k_pages, v_pages, page_table,
                                          pos)


def prefill_attention(q, k_cache, v_cache, pos, *, block_k=128, abort=None):
    if not _on_cpu(q):
        return _prefill.prefill_attention(q, k_cache, v_cache, pos,
                                          block_k=block_k, abort=abort)
    out = ref.ref_prefill_attention(q, k_cache.transpose(1, 2),
                                    v_cache.transpose(1, 2), pos)
    return _with_progress(out, abort, q.shape[0], q.shape[1])


def prefill_attention_paged(q, k_pages, v_pages, page_table, pos, *,
                            abort=None):
    if not _on_cpu(q):
        return _prefill.prefill_attention_paged(q, k_pages, v_pages,
                                                page_table, pos, abort=abort)
    out = ref.ref_prefill_attention_paged(q, k_pages, v_pages, page_table,
                                          pos)
    return _with_progress(out, abort, q.shape[0], q.shape[1])


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None,
                    block_q=128, block_k=128):
    if not _on_cpu(q):
        return _flash.flash_attention(q, k, v, causal=causal, window=window,
                                      softcap=softcap, block_q=block_q,
                                      block_k=block_k)
    return ref.ref_attention(q, k, v, causal=causal, window=window,
                             softcap=softcap)


def dual_tenant_attention(q_ls, k_ls, v_ls, q_be, k_be, v_be, *, sm_be=0.3,
                          block_q=128, block_k=128, round_tiles=8):
    if not _on_cpu(q_ls):
        return _dta.dual_tenant_attention(
            q_ls, k_ls, v_ls, q_be, k_be, v_be, sm_be=sm_be,
            block_q=block_q, block_k=block_k, round_tiles=round_tiles)
    return (ref.ref_attention(q_ls, k_ls, v_ls, causal=True),
            ref.ref_attention(q_be, k_be, v_be, causal=True))


def dual_tenant_matmul(a_ls, b_ls, a_be, b_be, *, sm_be=0.3, block_m=128,
                       block_n=128, block_k=128):
    if not _on_cpu(a_ls):
        return _dtm.dual_tenant_matmul(a_ls, b_ls, a_be, b_be, sm_be=sm_be,
                                       block_m=block_m, block_n=block_n,
                                       block_k=block_k)
    return ref.ref_dual_tenant_matmul(a_ls, b_ls, a_be, b_be)


def spt_gather(arena, spt):
    if not _on_cpu(arena):
        return _spt.spt_gather(arena, spt)
    return ref.ref_spt_gather(arena, torch.as_tensor(spt))


def spt_scatter(x, spt, n_arena_pages):
    if not _on_cpu(x):
        return _spt.spt_scatter(x, spt, n_arena_pages)
    return ref.ref_spt_scatter(x, torch.as_tensor(spt), n_arena_pages)


def ssd_scan(q, k, v, log_w, *, chunk=64):
    if not _on_cpu(q):
        return _ssd.ssd_scan(q, k, v, log_w, chunk=chunk)
    _ssd.chunk_len(q.shape[1], chunk)
    return ref.ref_ssd_scan(q, k, v, log_w)
