"""RWKV-6 7B ("Finch") — attention-free, data-dependent decay.
[arXiv:2404.05892]"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,                    # d_model / head_dim
    num_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    attn_type="none",
    layer_pattern=("rwkv",),
    ssm=SSMConfig(kind="rwkv6", head_dim=64, chunk=64),
    use_rope=False,
    mlp_act="sq_relu",
)
