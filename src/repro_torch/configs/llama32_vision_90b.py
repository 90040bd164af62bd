"""Llama-3.2-Vision 90B — decoder with gated cross-attention image layers
every 5th layer; vision frontend is a STUB (input_specs provides precomputed
patch embeddings). [hf:meta-llama/Llama-3.2-90B-Vision]"""
from .base import ModelConfig, VisionConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    layer_pattern=("global", "global", "global", "global", "cross"),
    vision=VisionConfig(num_tokens=1601, vision_dim=4096, cross_attn_interval=5),
    mlp_act="swiglu",
    rope_theta=500_000.0,
)
