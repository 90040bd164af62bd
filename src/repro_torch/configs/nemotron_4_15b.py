"""Nemotron-4 15B — dense GQA, squared-ReLU MLP. [arXiv:2402.16819]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    mlp_act="sq_relu",
    rope_theta=10_000.0,
)
