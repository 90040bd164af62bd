"""Deterministic synthetic data pipeline, shardable across hosts
(``repro.train.data`` in PyTorch).

Two modes:
  * "random"  — iid uniform tokens (throughput/bench work),
  * "pattern" — learnable sequences (next token is a fixed affine map of the
    current one, occasionally corrupted) so examples can show loss decreasing.

Determinism: batch `step` is a pure function of (seed, step) — any host can
reconstruct any shard, which is what elastic restart requires.

``DataConfig`` and ``host_shard`` are verbatim copies of the reference's
(numpy): the token batches are the reference's, bit for bit. The extra
fields of ``device_batch`` (the encoder's frames, the VLM's image
features) come from a ``torch.Generator`` and cannot equal the
reference's ``jax.random`` draws.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    mode: str = "pattern"          # pattern | random
    noise: float = 0.05
    seed: int = 0


def host_shard(cfg: DataConfig, step: int, host_id: int = 0,
               num_hosts: int = 1):
    """Token batch for this host's rows at `step` (numpy, no device state)."""
    assert cfg.global_batch % num_hosts == 0
    rows = cfg.global_batch // num_hosts
    rng = np.random.default_rng((cfg.seed, step, host_id))
    if cfg.mode == "random":
        toks = rng.integers(0, cfg.vocab_size, (rows, cfg.seq_len + 1),
                            dtype=np.int32)
    else:
        toks = np.empty((rows, cfg.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, rows)
        mult = 6364136223846793005 % cfg.vocab_size
        for t in range(cfg.seq_len):
            nxt = (toks[:, t] * mult + 12345) % cfg.vocab_size
            noise = rng.random(rows) < cfg.noise
            nxt = np.where(noise,
                           rng.integers(0, cfg.vocab_size, rows), nxt)
            toks[:, t + 1] = nxt
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def device_batch(cfg: DataConfig, step: int, extra_fields=None,
                 device="cuda"):
    """The global batch (single-host path) on ``device``: ``host_shard``'s
    tokens and labels, then each of ``extra_fields`` ((name, shape, dtype)
    as ``models.io.batch_fields`` gives them) drawn in order from one
    generator seeded by ``(seed * 7919 + step) % 2**31``: int32 fields
    uniform over the vocabulary, the others standard normal (drawn in
    f32, then cast)."""
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in host_shard(cfg, step).items()}
    if extra_fields:
        g = torch.Generator(device=device)
        g.manual_seed((cfg.seed * 7919 + step) % (2 ** 31))
        for name, shape, dtype in extra_fields:
            if dtype == torch.int32:
                batch[name] = torch.randint(0, cfg.vocab_size, shape,
                                            generator=g, device=device,
                                            dtype=torch.int32)
            else:
                batch[name] = torch.randn(shape, generator=g, device=device,
                                          dtype=torch.float32).to(dtype)
    return batch
