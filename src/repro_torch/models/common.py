"""Shared model building blocks: dtypes, init, norms, RoPE, activations
(``repro.models.common`` in PyTorch).

Parameters are plain nested dicts of tensors. Initializers take an explicit
``torch.Generator`` seed and derive one generator per leaf from the leaf's
path (crc32, stable across processes), so init is order-independent and
reproducible. They give other numbers than ``jax.random`` from the same seed:
tests that compare with the reference hand both sides the same weights
through :mod:`repro_torch.bridge`.
"""
from __future__ import annotations

import zlib

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# dtype helpers
# ---------------------------------------------------------------------------

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dt(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def leaf_generator(seed: int, path: str, device) -> torch.Generator:
    """A generator for one parameter leaf, seeded from (seed, path)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + zlib.crc32(path.encode()))
                  % (2 ** 63))
    return g


def dense_init(seed: int, path: str, shape, dtype, device,
               fan_in: int | None = None):
    """Truncated-normal init scaled by 1/sqrt(fan_in). ``fan_in`` defaults
    to ``shape[-2]`` (``shape[-1]`` for vectors); a stacked
    ``[n_periods, ...]`` leaf passes the per-layer fan-in."""
    if fan_in is None:
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    x = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0,
                                generator=leaf_generator(seed, path, device))
    return (x * fan_in ** -0.5).to(dtype)


def embed_init(seed: int, path: str, shape, dtype, device):
    x = torch.randn(shape, dtype=torch.float32, device=device,
                    generator=leaf_generator(seed, path, device))
    return (x * shape[-1] ** -0.5).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x, gamma, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + gamma.float())).to(x.dtype)


def layer_norm(x, gamma, beta, eps: float = 1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * gamma.float() + beta.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float):
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))


def apply_rope(x, positions, theta: float = 10_000.0):
    """x: [..., S, H, D] (or [..., S, D]); positions: [..., S] int.
    Split halves (not interleaved), angles in f32."""
    d = x.shape[-1]
    freqs = torch.from_numpy(rope_freqs(d, theta)).to(x.device)
    ang = positions.float()[..., None] * freqs              # [..., S, d/2]
    # broadcast over the head axis if present
    for _ in range(x.dim() - ang.dim()):
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def sq_relu(x):
    r = F.relu(x)
    return r * r


def _gelu_tanh(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {
    "gelu": _gelu_tanh,
    "sq_relu": sq_relu,
    "silu": F.silu,
}


def softcap(x, cap: float):
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------

def causal_mask(q_len: int, kv_len: int, q_offset=0, device=None):
    """[q_len, kv_len] bool, True = attend."""
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    k_pos = torch.arange(kv_len, device=device)[None, :]
    return k_pos <= q_pos


def local_mask(q_len: int, kv_len: int, window: int, q_offset=0,
               device=None):
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    k_pos = torch.arange(kv_len, device=device)[None, :]
    return (k_pos <= q_pos) & (k_pos > q_pos - window)
