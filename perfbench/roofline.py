"""The yardstick: the card's peaks and the least time the work of a call
needs, from its shapes alone.

A rewrite of ``chip_smoke.py``'s ``_bound_ms``, ``_attn_work`` and
``_bound``, kept here so that it does not move when the program does. The
convention is theirs: each input byte read once and each output byte
written once, whatever a kernel reads again, and the operations the
visible (query, key) pairs and the weights need; the least time is the
larger of bytes over the HBM rate and operations over the type's peak.
Only the rows a call serves count (a row at the engine's write sentinel
needs nothing).

Peaks: NVIDIA H100 SXM data sheet, dense, at the full 700 W limit.
"""
from __future__ import annotations

from typing import Iterable, Tuple

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def bound_s(nbytes: float, flops: float, dtype: str) -> float:
    """Least seconds: bytes over the HBM rate or operations over the
    type's peak, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def prefill_attn_work(starts: Iterable[int], Sq: int, H: int, Hkv: int,
                      D: int, itemsize: int) -> Tuple[float, float]:
    """(bytes, operations) of one cached-context prefill launch over the
    served rows, whose chunks start at ``starts``: each row reads the K/V
    of its ``start + Sq`` keys and its q once and writes its out once;
    4 * D operations per visible (query, key) pair and head."""
    nbytes = flops = 0.0
    for p in starts:
        keys = p + Sq
        pairs = Sq * p + Sq * (Sq + 1) // 2
        nbytes += (2 * keys * Hkv * D + 2 * Sq * H * D) * itemsize
        flops += 4.0 * D * H * pairs
    return nbytes, flops


def decode_attn_work(positions: Iterable[int], H: int, Hkv: int, D: int,
                     itemsize: int) -> Tuple[float, float]:
    """(bytes, operations) of one decode launch over the served rows, each
    writing its token at ``pos`` and attending to keys 0..pos."""
    nbytes = flops = 0.0
    for p in positions:
        keys = p + 1
        nbytes += (2 * keys * Hkv * D + 2 * H * D) * itemsize
        flops += 4.0 * D * H * keys
    return nbytes, flops


def layer_matmul_params(arch: dict) -> int:
    """Weights one layer multiplies by: q, k, v, o and the MLP."""
    D, H, Hkv, Dh, F = (arch["d_model"], arch["num_heads"],
                        arch["num_kv_heads"], arch["head_dim"], arch["d_ff"])
    attn = D * H * Dh + 2 * D * Hkv * Dh + H * Dh * D
    mlp = (3 if arch["mlp_act"] == "swiglu" else 2) * D * F
    return attn + mlp


def prefill_flops(arch: dict, starts: Iterable[int], Sq: int) -> float:
    """Model operations of one prefill call over its served rows: the
    layers' products for each of the row's Sq tokens, attention over the
    visible context, and the head for the row's last position (the call
    returns only that position's logits)."""
    L, D, V = arch["num_layers"], arch["d_model"], arch["vocab_size"]
    H, Dh = arch["num_heads"], arch["head_dim"]
    per_tok = 2.0 * layer_matmul_params(arch) * L
    flops = 0.0
    for p in starts:
        pairs = Sq * p + Sq * (Sq + 1) // 2
        flops += per_tok * Sq + 2.0 * D * V + 4.0 * Dh * H * L * pairs
    return flops


def decode_flops(arch: dict, positions: Iterable[int]) -> float:
    """Model operations of one decode call over its served rows."""
    L, D, V = arch["num_layers"], arch["d_model"], arch["vocab_size"]
    H, Dh = arch["num_heads"], arch["head_dim"]
    per_tok = 2.0 * layer_matmul_params(arch) * L + 2.0 * D * V
    return sum(per_tok + 4.0 * Dh * H * L * (p + 1) for p in positions)


def decode_bytes(arch: dict, positions: Iterable[int], itemsize: int) \
        -> float:
    """Bytes one decode call must move at least: every weight it multiplies
    by once (the layers' and the head) and each served row's live K/V."""
    L, D, V = arch["num_layers"], arch["d_model"], arch["vocab_size"]
    Hkv, Dh = arch["num_kv_heads"], arch["head_dim"]
    weights = layer_matmul_params(arch) * L + D * V
    kv = sum(L * 2 * Hkv * Dh * (p + 1) for p in positions)
    return (weights + kv) * itemsize
