"""Architecture registry: full configs, reduced smoke variants, and the
(arch x shape) dry-run cell grid."""
from __future__ import annotations

import dataclasses

from .base import (EncoderConfig, MLAConfig, ModelConfig, MoEConfig,
                   SHAPES, SSMConfig, ShapeConfig, VisionConfig,
                   cell_applicable)
from .nemotron_4_15b import CONFIG as NEMOTRON
from .stablelm_1_6b import CONFIG as STABLELM
from .qwen3_1_7b import CONFIG as QWEN3
from .gemma2_9b import CONFIG as GEMMA2
from .deepseek_v2_236b import CONFIG as DEEPSEEK
from .moonshot_v1_16b_a3b import CONFIG as MOONSHOT
from .whisper_small import CONFIG as WHISPER
from .rwkv6_7b import CONFIG as RWKV6
from .llama32_vision_90b import CONFIG as LLAMA_VISION
from .zamba2_1_2b import CONFIG as ZAMBA2

ARCHS: dict[str, ModelConfig] = {c.name: c for c in [
    NEMOTRON, STABLELM, QWEN3, GEMMA2, DEEPSEEK, MOONSHOT, WHISPER, RWKV6,
    LLAMA_VISION, ZAMBA2,
]}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: small widths, few
    layers/experts, tiny vocab — structure preserved."""
    cfg = get_config(name)
    kw = dict(
        d_model=128,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads * 4 // cfg.num_heads, 4)),
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        local_window=cfg.local_window and 16,
        max_position=128,
        activation_dtype="float32",
    )
    period = len(cfg.layer_pattern)
    kw["num_layers"] = cfg.n_prefix + 2 * period
    if cfg.moe:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=8, top_k=2, d_ff_expert=64,
            d_ff_dense=256, num_shared_experts=min(cfg.moe.num_shared_experts, 1))
        kw["d_ff"] = 256
    if cfg.ssm:
        kw["ssm"] = dataclasses.replace(cfg.ssm, state_dim=16, head_dim=32,
                                        chunk=8)
        kw["num_heads"] = 128 // 32
        kw["num_kv_heads"] = 128 // 32
    if cfg.mla:
        kw["mla"] = MLAConfig(kv_lora_rank=32, q_lora_rank=48,
                              qk_nope_head_dim=32, qk_rope_head_dim=16,
                              v_head_dim=32)
    if cfg.encoder:
        kw["encoder"] = EncoderConfig(num_layers=2, num_frames=12)
        kw["num_layers"] = 2
    if cfg.vision:
        kw["vision"] = VisionConfig(num_tokens=8, vision_dim=64,
                                    cross_attn_interval=cfg.vision.cross_attn_interval)
    return cfg.replace(**kw)


def dryrun_cells():
    """Yield (cfg, shape, applicable, why) for the 40-cell grid."""
    for name in sorted(ARCHS):
        cfg = ARCHS[name]
        for sname in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            shape = SHAPES[sname]
            ok, why = cell_applicable(cfg, shape)
            yield cfg, shape, ok, why
