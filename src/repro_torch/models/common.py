"""Shared model building blocks: dtypes, init, norms, RoPE, activations
(``repro.models.common`` in PyTorch).

Parameters are plain nested dicts of tensors. Initializers take an explicit
``torch.Generator`` seed and derive one generator per leaf from the leaf's
path (crc32, stable across processes), so init is order-independent and
reproducible. They give other numbers than ``jax.random`` from the same seed:
tests that compare with the reference hand both sides the same weights
through :mod:`repro_torch.bridge`. On ``device="meta"`` they draw nothing
and give the leaf's shape and dtype alone (the dry run's abstract params,
the reference's ``jax.eval_shape`` of its init).
"""
from __future__ import annotations

import zlib

import numpy as np
import torch
import torch.nn.functional as F

from ..dist.sharding import reshard

# ---------------------------------------------------------------------------
# dtype helpers
# ---------------------------------------------------------------------------

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


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


def _meta(device) -> bool:
    return torch.device(device).type == "meta"


def dense_init(seed: int, path: str, shape, dtype, device,
               fan_in: int | None = None):
    """Truncated-normal init scaled by 1/sqrt(fan_in). ``fan_in`` defaults
    to ``shape[-2]`` (``shape[-1]`` for vectors); a stacked
    ``[n_periods, ...]`` leaf passes the per-layer fan-in."""
    if _meta(device):
        return torch.empty(shape, dtype=dtype, device=device)
    if fan_in is None:
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    x = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0,
                                generator=leaf_generator(seed, path, device))
    return (x * fan_in ** -0.5).to(dtype)


def dense_init_sliced(seed: int, path: str, lead, shape, dtype, device):
    """:func:`dense_init` of a ``lead + shape`` leaf drawn one ``lead``
    slice at a time, each from a generator seeded from (seed, path, slice
    index) and written into the leaf in ``dtype``: only one slice is ever
    held in f32. Fan-in is ``shape[-2]``. The MoE expert leaves take this
    path: moonshot-v1-16b-a3b's ``[47, 64, 2048, 1408]`` would be 34.7 GB
    in f32 whole."""
    lead, shape = tuple(lead), tuple(shape)
    out = torch.empty(lead + shape, dtype=dtype, device=device)
    if _meta(device):
        return out
    flat = out.view((-1,) + shape)
    for i in range(flat.shape[0]):
        flat[i] = dense_init(seed, f"{path}/{i}", shape, dtype, device)
    return out


def embed_init(seed: int, path: str, shape, dtype, device):
    if _meta(device):
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, dtype=torch.float32, device=device,
                    generator=leaf_generator(seed, path, device))
    return (x * shape[-1] ** -0.5).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def _whole(gamma):
    """A norm's scale whole on every rank: a stacked layer's scale is
    split on its width by the rules, and XLA gathers it (in a mesh; the
    identity elsewhere)."""
    return reshard(gamma, ()) if hasattr(gamma, "placements") else gamma


def wide(x):
    """``x`` in the precision a norm computes in: f32, or f64 for f64
    ``x``."""
    return x if x.dtype == torch.float64 else x.float()


def rms_norm(x, gamma, eps: float = 1e-6):
    gamma = _whole(gamma)
    xf = wide(x)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + gamma.to(xf.dtype))).to(x.dtype)


def layer_norm(x, gamma, beta, eps: float = 1e-5):
    gamma, beta = _whole(gamma), _whole(beta)
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
