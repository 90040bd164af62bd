"""Zamba2 1.2B — Mamba2 backbone with a shared attention block invoked every
6th layer (per-invocation input projections). [arXiv:2411.15242]

38 layers = 2 prefix mamba layers + 6 periods x (5 mamba + 1 mamba+shared).
"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,                       # shared block MLP width
    vocab_size=32000,
    attn_type="gqa",
    layer_pattern=("mamba", "mamba", "mamba", "mamba", "mamba",
                   "mamba_shared"),
    prefix_layers=2,
    ssm=SSMConfig(kind="mamba2", state_dim=64, head_dim=64, expand=2,
                  chunk=64, conv_dim=4),
    tie_embeddings=True,
    mlp_act="swiglu",
)
