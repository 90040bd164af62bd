"""DeepSeek-V2 236B — MLA (kv_lora=512) + MoE (2 shared + 160 routed top-6),
first layer dense. [arXiv:2405.04434]"""
from .base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=12288,                      # dense-prefix FFN width
    vocab_size=102400,
    attn_type="mla",
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=160, top_k=6, num_shared_experts=2,
                  d_ff_expert=1536, first_dense_layers=1, d_ff_dense=12288,
                  capacity_factor=1.25),
    mlp_act="swiglu",
    rope_theta=10_000.0,
)
