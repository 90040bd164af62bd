"""Model inputs (``repro.models.io`` in PyTorch): the fields every model
takes, concrete batches drawn from an explicit ``torch.Generator``, and
abstract ones on the meta device (the dry run's stand-ins, no allocation).
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig


def batch_fields(cfg: ModelConfig, B: int, S: int, with_labels=True):
    """(name, shape, dtype) for every model input."""
    act = (torch.bfloat16 if cfg.activation_dtype == "bfloat16"
           else torch.float32)
    fields = [("tokens", (B, S), torch.int32)]
    if with_labels:
        fields.append(("labels", (B, S), torch.int32))
    if cfg.encoder:
        fields.append(("frames", (B, cfg.encoder.num_frames, cfg.d_model),
                       act))
    if cfg.vision:
        fields.append(("vision", (B, cfg.vision.num_tokens,
                                  cfg.vision.vision_dim), act))
    return fields


def make_batch(cfg: ModelConfig, B: int, S: int, generator: torch.Generator,
               with_labels=True):
    """A batch on ``generator``'s device: token ids uniform over the
    vocabulary, frames and image features standard normal (drawn in f32,
    then cast), one field after another in :func:`batch_fields`'s order."""
    dev = generator.device
    out = {}
    for name, shape, dtype in batch_fields(cfg, B, S, with_labels):
        if dtype == torch.int32:
            out[name] = torch.randint(0, cfg.vocab_size, shape,
                                      generator=generator, device=dev,
                                      dtype=torch.int32)
        else:
            out[name] = torch.randn(shape, generator=generator, device=dev,
                                    dtype=torch.float32).to(dtype)
    return out


def abstract_batch(cfg: ModelConfig, B: int, S: int, with_labels=True):
    """Every field of :func:`batch_fields` as an empty meta tensor of its
    shape and dtype."""
    return {name: torch.empty(shape, dtype=dtype, device="meta")
            for name, shape, dtype in batch_fields(cfg, B, S, with_labels)}
