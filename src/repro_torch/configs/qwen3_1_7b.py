"""Qwen3 1.7B — dense GQA with qk-norm. [hf:Qwen/Qwen3-1.7B]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    qk_norm=True,
    tie_embeddings=True,
    mlp_act="swiglu",
    rope_theta=1_000_000.0,
)
