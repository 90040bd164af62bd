"""Whisper-small — encoder-decoder; conv/audio frontend is a STUB
(input_specs provides precomputed frame embeddings). [arXiv:2212.04356]"""
from .base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,                   # decoder layers
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    encoder=EncoderConfig(num_layers=12, num_frames=1500),
    use_rope=False,                  # learned positions
    tie_embeddings=True,
    mlp_act="gelu",
)
