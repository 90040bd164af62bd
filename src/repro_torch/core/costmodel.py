"""Analytic cost model: per-layer FLOPs and HBM bytes for every architecture
and execution mode. Single source of truth for
  * the contention simulator's kernel profiles (core/simulator.py),
  * MODEL_FLOPS in the roofline analysis (benchmarks/roofline.py),
  * the SGDRC controller's memory-bound-op detection (Thres_DRAM, §5.3).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

from ..configs.base import ModelConfig


@dataclass(frozen=True)
class OpCost:
    name: str
    flops: float
    bytes: float          # HBM traffic (weights + activations, bf16)

    @property
    def intensity(self) -> float:
        return self.flops / max(self.bytes, 1.0)


def _bytes_per(dtype_bits=16):
    return dtype_bits / 8


def kv_token_bytes(cfg: ModelConfig, dtype_bytes: float = None) -> float:
    """KV-cache bytes one token occupies in ONE attention layer (the single
    source of truth shared with serving.kv_cache's capacity accounting):
    MLA caches the compressed latent (R + rope), GQA caches k + v heads."""
    bp = _bytes_per() if dtype_bytes is None else dtype_bytes
    if cfg.attn_type == "mla":
        return (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim) * bp
    return 2 * cfg.num_kv_heads * cfg.head_dim * bp


def _kv_write_cost(cfg: ModelConfig, B, Skv, kind, kv_write, bp) -> OpCost:
    """Decode-step KV-cache *write* traffic for one layer. ``"scatter"`` is
    the whole-row mask-scatter (reads + rewrites the full [Smax] window
    every token); ``"dus"``/``"paged"`` write one token (dynamic-update
    -slice / one page-table entry per row)."""
    tok = kv_token_bytes(cfg, bp)
    if kv_write == "scatter":
        nbytes = 2.0 * B * Skv * tok          # read-modify-write, full window
    else:                                     # "dus" | "paged"
        nbytes = float(B) * tok
    return OpCost(f"kv_write_{kind}", 0.0, nbytes)


def attn_costs(cfg: ModelConfig, B, Sq, Skv, kind="global", decode=False,
               kv_write=None):
    """QKV/O projections + attention core for one layer. In decode mode
    ``kv_write`` adds the cache-write traffic term (see _kv_write_cost)."""
    D, H, Dh = cfg.d_model, cfg.num_heads, cfg.head_dim
    Hkv = cfg.num_kv_heads
    bp = _bytes_per()
    T = B * Sq
    ops = []
    if decode and kv_write:
        ops.append(_kv_write_cost(cfg, B, Skv, kind, kv_write, bp))
    if cfg.attn_type == "mla":
        m = cfg.mla
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        w = (D * m.q_lora_rank + m.q_lora_rank * H * qk
             + D * (m.kv_lora_rank + m.qk_rope_head_dim)
             + m.kv_lora_rank * H * (m.qk_nope_head_dim + m.v_head_dim)
             + H * m.v_head_dim * D)
        ops.append(OpCost("mla_proj", 2 * T * w, (w + 2 * T * D) * bp))
        kv_eff = Skv if kind == "global" else min(Skv, cfg.local_window or Skv)
        core_flops = 2 * B * Sq * kv_eff * H * (qk + m.v_head_dim)
        kv_bytes = B * Skv * (m.kv_lora_rank + m.qk_rope_head_dim) * bp
        ops.append(OpCost("mla_attn", core_flops,
                          kv_bytes + 2 * T * H * qk * bp))
        return ops
    w_qkvo = D * H * Dh + 2 * D * Hkv * Dh + H * Dh * D
    ops.append(OpCost(f"attn_proj_{kind}", 2 * T * w_qkvo,
                      (w_qkvo + 2 * T * D) * bp))
    kv_eff = Skv if kind == "global" else min(Skv, cfg.local_window or Skv)
    core = 4 * B * Sq * kv_eff * H * Dh            # qk^T + av
    kv_bytes = 2 * B * Skv * Hkv * Dh * bp         # KV cache read
    ops.append(OpCost(f"attn_core_{kind}", core,
                      kv_bytes + 2 * T * H * Dh * bp))
    return ops


def mlp_costs(cfg: ModelConfig, B, S, d_ff=None):
    D = cfg.d_model
    F = d_ff or cfg.d_ff
    bp = _bytes_per()
    T = B * S
    n_mats = 3 if cfg.mlp_act == "swiglu" else 2
    w = n_mats * D * F
    return [OpCost("mlp", 2 * T * w, (w + 2 * T * D + T * F) * bp)]


def moe_costs(cfg: ModelConfig, B, S):
    m = cfg.moe
    D = cfg.d_model
    bp = _bytes_per()
    T = B * S
    F = m.d_ff_expert
    ops = [OpCost("router", 2 * T * D * m.num_experts, T * D * bp)]
    # routed experts: top_k * capacity_factor tokens worth of compute;
    # weights traffic: all experts touched (worst case, EP-local slice reads)
    eff_T = T * m.top_k * m.capacity_factor
    w_routed = 3 * D * F * m.num_experts
    ops.append(OpCost("experts", 2 * eff_T * 3 * D * F,
                      (w_routed + 2 * eff_T * D) * bp))
    if m.num_shared_experts:
        Fs = m.num_shared_experts * F
        w_sh = 3 * D * Fs
        ops.append(OpCost("shared_experts", 2 * T * w_sh,
                          (w_sh + 2 * T * D) * bp))
    return ops


def ssm_costs(cfg: ModelConfig, B, S, kind):
    D = cfg.d_model
    s = cfg.ssm
    bp = _bytes_per()
    T = B * S
    ops = []
    if kind == "rwkv":
        w = 5 * D * D                                 # r,k,v,g,o projections
        ops.append(OpCost("rwkv_proj", 2 * T * w, (w + 2 * T * D) * bp))
        H = D // s.head_dim
        K = s.head_dim
        # state update + readout: O(T * H * K * K)
        ops.append(OpCost("rwkv_scan", 6 * T * H * K * K,
                          (2 * T * D + B * H * K * K) * bp))
        w_cm = D * cfg.d_ff * 2 + D * D
        ops.append(OpCost("rwkv_cm", 2 * T * w_cm, (w_cm + 2 * T * D) * bp))
    else:  # mamba2
        d_in = s.expand * D
        w = D * (2 * d_in + 2 * s.state_dim + d_in // s.head_dim) + d_in * D
        ops.append(OpCost("mamba_proj", 2 * T * w, (w + 2 * T * D) * bp))
        H = d_in // s.head_dim
        ops.append(OpCost("mamba_scan",
                          6 * T * H * s.state_dim * s.head_dim,
                          (2 * T * d_in + B * H * s.state_dim * s.head_dim)
                          * bp))
    return ops


def layer_costs(cfg: ModelConfig, B, Sq, Skv, kind, moe_layer: bool,
                d_ff=None, decode=False, kv_write=None) -> List[OpCost]:
    base = kind.replace("_shared", "")
    ops: List[OpCost] = []
    if base in ("global", "local"):
        ops += attn_costs(cfg, B, Sq, Skv, base, decode=decode,
                          kv_write=kv_write)
        ops += (moe_costs(cfg, B, Sq) if moe_layer
                else mlp_costs(cfg, B, Sq, d_ff))
    elif base == "cross":
        nv = cfg.vision.num_tokens
        D, H, Dh = cfg.d_model, cfg.num_heads, cfg.head_dim
        bp = _bytes_per()
        w = D * H * Dh + 2 * cfg.vision.vision_dim * cfg.num_kv_heads * Dh + H * Dh * D
        ops.append(OpCost("cross_proj", 2 * B * (Sq + 2 * nv) * D * H * Dh // 1,
                          (w + 2 * B * Sq * D + B * nv * cfg.vision.vision_dim) * bp))
        ops.append(OpCost("cross_core", 4 * B * Sq * nv * H * Dh,
                          2 * B * Sq * H * Dh * bp))
        ops += mlp_costs(cfg, B, Sq, d_ff)
    elif base in ("rwkv", "mamba"):
        ops += ssm_costs(cfg, B, Sq, base)
    if kind.endswith("_shared"):
        ops += attn_costs(cfg, B, Sq, Skv, "global")
        ops += mlp_costs(cfg, B, Sq)
        D = cfg.d_model
        ops.append(OpCost("shared_proj", 2 * B * Sq * 2 * D * D,
                          (2 * D * D + 3 * B * Sq * D) * _bytes_per()))
    return ops


def model_costs(cfg: ModelConfig, B: int, S: int, mode: str,
                kv_write=None, prefix: int = 0,
                chunk=None, swap_bytes: int = 0,
                xfer_bytes: int = 0) -> List[OpCost]:
    """mode: train | prefill | decode. decode: Sq=1, Skv=S. train adds
    backward (2x fwd flops for grads) via the TRAIN_MULT on the caller side —
    here we return FORWARD costs; see step_costs(). ``kv_write`` (decode
    only): "scatter" models the whole-row mask-scatter cache write,
    "dus"/"paged" the one-token fast paths; None (default) omits the term
    (the historical behaviour). ``prefix`` (prefill only) is the number of
    leading prompt tokens whose KV is already resident (a prefix-cache hit):
    only the uncached suffix is computed (Sq = S - prefix) while attention
    still reads the full Skv = S window — the traffic/FLOPs saving the
    radix-tree page sharing buys. ``chunk`` (prefill only) models *chunked*
    prefill: the uncached span is computed ``chunk`` query tokens at a time,
    each chunk re-reading its prefix KV and the layer weights — the
    chunking bandwidth tax the serving scheduler pays for bounded TBT. The
    op list concatenates the per-chunk costs, so the planner sees both the
    tax and the per-chunk preemption granularity. ``swap_bytes`` appends a
    zero-FLOP ``swap_pcie`` op carrying the request's KV swap traffic (host
    tier page faults), so swap cost flows through the same per-class
    bandwidth accounting as every other byte. ``xfer_bytes`` likewise
    appends a zero-FLOP ``kv_xfer`` op: the request's cross-device KV
    page-group transfer (disaggregated prefill/decode, core.interconnect),
    charged to the owning class's bandwidth split like swap traffic."""
    if mode == "prefill" and prefix:
        prefix = min(int(prefix), max(S - 1, 0))
    else:
        prefix = 0
    if mode == "prefill" and chunk and prefix + chunk < S:
        ops: List[OpCost] = []
        start = prefix
        while start < S:
            end = min(start + int(chunk), S)
            # one chunk = a prefill of [start, end) over an end-token KV
            # window: attention reads the start-token prefix again
            ops += model_costs(cfg, B, end, "prefill",
                               prefix=start if start else 0)
            start = end
        if swap_bytes > 0:
            ops.append(OpCost("swap_pcie", 0.0, float(swap_bytes)))
        if xfer_bytes > 0:
            ops.append(OpCost("kv_xfer", 0.0, float(xfer_bytes)))
        return ops
    if mode == "prefill" and prefix:
        Sq, Skv = S - prefix, S
    else:
        Sq, Skv = (1, S) if mode == "decode" else (S, S)
    decode = mode == "decode"
    ops: List[OpCost] = []
    bp = _bytes_per()
    pattern = cfg.pattern
    n_prefix = cfg.n_prefix
    dense_ff = (cfg.moe.d_ff_dense if cfg.moe and cfg.moe.d_ff_dense else None)
    for i, kind in enumerate(pattern):
        moe_layer = bool(cfg.moe) and i >= n_prefix
        ops += layer_costs(cfg, B, Sq, Skv, kind,
                           moe_layer, None if moe_layer or i >= n_prefix
                           else dense_ff, decode=decode, kv_write=kv_write)
    if cfg.encoder and mode != "decode":
        ecfg = cfg
        F = cfg.encoder.num_frames
        for _ in range(cfg.encoder.num_layers):
            ops += attn_costs(ecfg, B, F, F, "global")
            ops += mlp_costs(ecfg, B, F)
    T = B * Sq
    ops.append(OpCost("embed", 0.0, T * cfg.d_model * bp))
    ops.append(OpCost("unembed", 2 * T * cfg.d_model * cfg.vocab_size,
                      (cfg.d_model * cfg.vocab_size + T * cfg.vocab_size) * bp))
    if swap_bytes > 0:
        ops.append(OpCost("swap_pcie", 0.0, float(swap_bytes)))
    if xfer_bytes > 0:
        ops.append(OpCost("kv_xfer", 0.0, float(xfer_bytes)))
    return ops


def step_costs(cfg: ModelConfig, B: int, S: int, mode: str):
    """(total_flops, total_bytes). Training multiplies forward FLOPs by 3
    (fwd + 2x bwd) and bytes by ~3 (grads + optimizer traffic)."""
    ops = model_costs(cfg, B, S, mode)
    f = sum(o.flops for o in ops)
    b = sum(o.bytes for o in ops)
    if mode == "train":
        return 3.0 * f, 3.0 * b
    return f, b


# ---------------------------------------------------------------------------
# parameter counts (for 6ND MODEL_FLOPS and memory budgeting)
# ---------------------------------------------------------------------------

def param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    D = cfg.d_model
    n = cfg.vocab_size * D * (1 if cfg.tie_embeddings else 2)
    n_prefix = cfg.n_prefix
    for i, kind in enumerate(cfg.pattern):
        base = kind.replace("_shared", "")
        if base in ("global", "local", "cross"):
            if cfg.attn_type == "mla":
                m = cfg.mla
                qk = m.qk_nope_head_dim + m.qk_rope_head_dim
                n += (D * m.q_lora_rank + m.q_lora_rank * cfg.num_heads * qk
                      + D * (m.kv_lora_rank + m.qk_rope_head_dim)
                      + m.kv_lora_rank * cfg.num_heads
                      * (m.qk_nope_head_dim + m.v_head_dim)
                      + cfg.num_heads * m.v_head_dim * D)
            elif base == "cross":
                n += (D * cfg.num_heads * cfg.head_dim
                      + 2 * cfg.vision.vision_dim * cfg.num_kv_heads * cfg.head_dim
                      + cfg.num_heads * cfg.head_dim * D)
            else:
                n += (D * cfg.num_heads * cfg.head_dim
                      + 2 * D * cfg.num_kv_heads * cfg.head_dim
                      + cfg.num_heads * cfg.head_dim * D)
            if cfg.moe and i >= n_prefix:
                m = cfg.moe
                per = 3 * D * m.d_ff_expert
                routed = (m.top_k if active_only else m.num_experts) * per
                n += routed + m.num_shared_experts * per + D * m.num_experts
            else:
                dff = (cfg.moe.d_ff_dense if (cfg.moe and cfg.moe.d_ff_dense)
                       else cfg.d_ff)
                n += (3 if cfg.mlp_act == "swiglu" else 2) * D * dff
        elif base == "rwkv":
            n += 5 * D * D + 2 * D * cfg.d_ff + D * D
        elif base == "mamba":
            s = cfg.ssm
            d_in = s.expand * D
            n += D * (2 * d_in + 2 * s.state_dim + d_in // s.head_dim) + d_in * D
        if kind.endswith("_shared"):
            n += (4 * D * cfg.num_heads * cfg.head_dim
                  + 3 * D * cfg.d_ff + 2 * D * D)
    if cfg.encoder:
        per_enc = (4 * D * cfg.num_heads * cfg.head_dim + 2 * D * cfg.d_ff)
        n += cfg.encoder.num_layers * per_enc
        n += cfg.num_layers * (D * cfg.num_heads * cfg.head_dim * 2
                               + 2 * D * cfg.num_kv_heads * cfg.head_dim)
    return int(n)


def model_flops_reference(cfg: ModelConfig, tokens: int, mode: str) -> float:
    """The brief's reference number: 6*N*D (train) / 2*N*D (inference),
    N = active params."""
    n = param_count(cfg, active_only=True)
    return (6.0 if mode == "train" else 2.0) * n * tokens
