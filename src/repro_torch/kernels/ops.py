"""Dispatch for the attention kernels: the plain PyTorch version
(:mod:`.ref`) for CPU tensors, the CUDA kernel for CUDA tensors.

A CUDA tensor always launches its kernel, and a kernel that cannot run
raises: there is no fallback to the plain version. The CPU path exists for
tests and hosts without a card; it is the plain version only because the
tensor it was given lies on the CPU.
"""
from __future__ import annotations

import torch

from . import decode_attention as _decode
from . import prefill_attention as _prefill
from . import ref

#: every kernel wrapper, by name; each counts its launches in ``.launches``
KERNELS = {
    "decode_attention": _decode.decode_attention,
    "decode_attention_paged": _decode.decode_attention_paged,
    "prefill_attention": _prefill.prefill_attention,
    "prefill_attention_paged": _prefill.prefill_attention_paged,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts():
    for fn in KERNELS.values():
        fn.launches = 0


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
