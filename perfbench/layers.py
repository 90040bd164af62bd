"""Arithmetic that several per-layer readers share."""
from __future__ import annotations

import re

from . import roofline

#: the attention kernels' entry names (``kernels/csrc``)
KERNEL_NAME = {"prefill": re.compile(r"\bprefill_(wgmma|simt)_kernel\b"),
               "decode": re.compile(r"\bdecode_kernel\b")}


def pad_share(run, cls: str):
    calls = run.trace.in_window(run.timeline, cls, "prefill")
    total = sum(c.rows * c.sq for c in calls)
    if not total:
        return None
    served = sum(len(c.starts) * c.sq for c in calls)
    return 100.0 * (total - served) / total


def attn_roofline(run, kind: str):
    """Summed least time of the LS ``kind`` attention launches over their
    summed device time, percent; None without profiled launches."""
    arch, it = run.arch["LS"], roofline.ITEMSIZE[run.dtype]
    H, Hkv, D = arch["num_heads"], arch["num_kv_heads"], arch["head_dim"]
    pat = KERNEL_NAME[kind]
    least = device = 0.0
    for c in run.trace.in_window(run.timeline, "LS", kind):
        if c.kernels is None:
            continue
        t = [s for n, s in c.kernels if pat.search(n)]
        if not t:
            continue
        if kind == "prefill":
            w = roofline.prefill_attn_work(c.starts, c.sq, H, Hkv, D, it)
        else:
            w = roofline.decode_attn_work(c.starts, H, Hkv, D, it)
        least += len(t) * roofline.bound_s(*w, run.dtype)
        device += sum(t)
    return 100.0 * least / device if device > 0 else None
