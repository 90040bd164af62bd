"""Moonlight 16B-A3B (kimi/moonshot) — MoE 64 experts top-6, 2 shared.
[hf:moonshotai/Moonlight-16B-A3B]"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=11264,                      # dense-prefix FFN width
    vocab_size=163840,
    moe=MoEConfig(num_experts=64, top_k=6, num_shared_experts=2,
                  d_ff_expert=1408, first_dense_layers=1, d_ff_dense=11264,
                  capacity_factor=1.25),
    mlp_act="swiglu",
    rope_theta=50_000.0,
)
