"""Configuration dataclasses for the repro framework.

Every assigned architecture is expressed as a ``ModelConfig``; the input-shape
grid (train_4k / prefill_32k / decode_32k / long_500k) is expressed as
``ShapeConfig``.  Configs are plain frozen dataclasses so they hash, print, and
serialize trivially; ``replace``-style evolution is used for reduced smoke
variants and dry-run layer probes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    num_shared_experts: int = 0
    d_ff_expert: int = 0            # per-expert FFN width
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    first_dense_layers: int = 0     # leading dense layers (deepseek-style)
    d_ff_dense: int = 0             # width of those dense layers
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2


@dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba2"            # "mamba2" | "rwkv6"
    state_dim: int = 64             # N: per-head state size
    head_dim: int = 64              # P: channels per head
    expand: int = 2                 # d_inner = expand * d_model (mamba2)
    chunk: int = 64                 # chunked-scan block length
    conv_dim: int = 4               # short conv width (mamba2); 0 disables


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec models (whisper). Frontend is a STUB:
    input_specs() provides precomputed frame embeddings [B, num_frames, d_model]."""
    num_layers: int = 12
    num_frames: int = 1500


@dataclass(frozen=True)
class VisionConfig:
    """VLM cross-attention config. Frontend is a STUB: input_specs() provides
    precomputed patch embeddings [B, num_tokens, vision_dim]."""
    num_tokens: int = 1601
    vision_dim: int = 4096
    cross_attn_interval: int = 5    # a cross-attn layer every N decoder layers


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads
    # --- attention flavour ---
    attn_type: str = "gqa"          # gqa | mla | none
    qk_norm: bool = False
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    local_window: Optional[int] = None
    # layer pattern, repeated to num_layers. entries:
    #   "global" | "local" (attention blocks), "mamba", "rwkv", "shared_attn"
    layer_pattern: Tuple[str, ...] = ("global",)
    rope_theta: float = 10_000.0
    use_rope: bool = True
    # --- sub-configs ---
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    mla: Optional[MLAConfig] = None
    encoder: Optional[EncoderConfig] = None
    vision: Optional[VisionConfig] = None
    # --- MLP flavour ---
    mlp_act: str = "swiglu"         # swiglu | sq_relu | gelu
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # --- numerics / lowering ---
    param_dtype: str = "float32"
    activation_dtype: str = "bfloat16"
    scan_layers: bool = True        # lax.scan over layers (False => unrolled)
    remat: str = "none"             # none | full | dots
    # layers before the repeating pattern starts (deepseek first-dense,
    # zamba ragged head); these are unrolled, the rest is scanned
    prefix_layers: int = 0
    max_position: int = 32768       # learned-pos-embedding table size

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))
        if self.attn_type == "gqa":
            assert self.num_heads % max(self.num_kv_heads, 1) == 0, self.name

    # ---- evolution helpers -------------------------------------------------
    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def n_prefix(self) -> int:
        return self.prefix_layers or (self.moe.first_dense_layers if self.moe else 0)

    @property
    def probe_period(self) -> int:
        return len(self.layer_pattern)

    def with_layers(self, n_pattern_layers: int) -> "ModelConfig":
        """Copy with prefix + ``n_pattern_layers`` total pattern layers
        (must be a multiple of the pattern period, or 0). The whisper encoder
        is scaled in lockstep. Used by the dry-run's per-layer metric probes."""
        enc = self.encoder
        if enc is not None:
            enc = dataclasses.replace(
                enc, num_layers=n_pattern_layers // self.probe_period)
        return self.replace(num_layers=self.n_prefix + n_pattern_layers,
                            encoder=enc)

    @property
    def pattern(self) -> Tuple[str, ...]:
        reps = -(-self.num_layers // len(self.layer_pattern)) if self.num_layers else 0
        return tuple((self.layer_pattern * reps)[: self.num_layers])

    @property
    def is_sub_quadratic(self) -> bool:
        """True if the arch can run long_500k (no quadratic full-attention path
        scaling with context)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs autoregress (whisper via its decoder)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def cell_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether an (arch x shape) cell runs, and why not if it doesn't."""
    if shape.name == "long_500k" and not cfg.is_sub_quadratic:
        return False, "full-attention arch: 512K context is quadratic; skipped per brief"
    return True, ""
