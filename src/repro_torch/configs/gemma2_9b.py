"""Gemma-2 9B — local+global alternating attention, logit softcaps.
[arXiv:2408.00118]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    layer_pattern=("local", "global"),
    local_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    tie_embeddings=True,
    mlp_act="gelu",
    rope_theta=10_000.0,
)
