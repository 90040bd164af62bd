"""Offline MLP fit of the VRAM channel hash mapping (§5.2): the paper trains
a 9-layer MLP on ~15K probed (address -> channel) samples and reports >99.9%
accuracy on unseen physical addresses (``repro.core.coloring.mlp_fit`` in
PyTorch).

Input features: binary bits of the page index (granularity-aligned), which is
what the hash actually consumes. The fitted model generalizes to the whole
VRAM space; prediction errors are randomly scattered (paper §8.1.1), which the
allocator tolerates.

The MLP is a list of ``{"w", "b"}`` tensors with the reference's dims,
He-normal weights and GELU in its tanh form between layers; it is trained by
the reference's hand-written Adam (β 0.9/0.999, bias correction, eps 1e-8),
not ``torch.optim.Adam``, whose update order differs. Weights and minibatch
indices come from ``torch.Generator``s seeded from ``seed``, so they are
other numbers than the reference's ``jax.random`` draws: the fit is held to
the reference's accuracy bar, not to its weights.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F


def page_bits(addrs, granularity: int, n_bits: int = 24) -> np.ndarray:
    pages = np.asarray(addrs, np.int64) // granularity
    bits = ((pages[:, None] >> np.arange(n_bits)[None, :]) & 1)
    return (bits.astype(np.float32) * 2.0 - 1.0)


def init_mlp(seed: int, n_bits: int, n_channels: int, hidden: int = 256,
             depth: int = 9, device="cuda"):
    """He-normal weights drawn on the CPU from one generator seeded by
    ``seed`` (layer after layer), zero biases."""
    g = torch.Generator().manual_seed(int(seed))
    dims = [n_bits] + [hidden] * (depth - 1) + [n_channels]
    return [{"w": (torch.randn((a, b), generator=g) * (2.0 / a) ** 0.5
                   ).to(device),
             "b": torch.zeros((b,), device=device)}
            for a, b in zip(dims[:-1], dims[1:])]


def mlp_apply(params, x):
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i + 1 < len(params):
            x = F.gelu(x, approximate="tanh")    # jax.nn.gelu's default
    return x


@dataclass
class FitResult:
    params: list
    train_acc: float
    test_acc: float
    predict: Callable     # np addresses -> np channel ids
    n_bits: int


def fit_channel_hash(addrs, labels, granularity: int, n_channels: int,
                     *, n_bits: int = 24, hidden: int = 256, depth: int = 9,
                     steps: int = 3000, batch: int = 1024, lr: float = 1e-3,
                     test_frac: float = 0.2, seed: int = 0,
                     device="cuda") -> FitResult:
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(addrs))
    n_test = max(1, int(len(addrs) * test_frac))
    test_idx, train_idx = order[:n_test], order[n_test:]
    X = page_bits(addrs, granularity, n_bits)
    y = np.asarray(labels, np.int64)
    Xtr = torch.from_numpy(X[train_idx]).to(device)
    ytr = torch.from_numpy(y[train_idx]).to(device)
    Xte = torch.from_numpy(X[test_idx]).to(device)
    yte = torch.from_numpy(y[test_idx]).to(device)

    params = init_mlp(seed, n_bits, n_channels, hidden, depth, device)
    leaves = [layer[k] for layer in params for k in ("w", "b")]
    ms = [torch.zeros_like(p) for p in leaves]
    vs = [torch.zeros_like(p) for p in leaves]

    def loss(xb, yb):
        logits = mlp_apply(params, xb)
        return torch.mean(-torch.log_softmax(logits, dim=-1)[
            torch.arange(len(yb), device=yb.device), yb])

    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    for p in leaves:
        p.requires_grad_(True)
    for t in range(1, steps + 1):
        idx = torch.randint(0, Xtr.shape[0], (batch,), generator=gen,
                            device=device)
        grads = torch.autograd.grad(loss(Xtr[idx], ytr[idx]), leaves)
        with torch.no_grad():
            for p, m, v, g in zip(leaves, ms, vs, grads):
                m.mul_(0.9).add_(0.1 * g)
                v.mul_(0.999).add_(0.001 * g * g)
                mh = m / (1 - 0.9 ** t)
                vh = v / (1 - 0.999 ** t)
                p.sub_(lr * mh / (torch.sqrt(vh) + 1e-8))
    for p in leaves:
        p.requires_grad_(False)

    @torch.no_grad()
    def acc(xb, yb):
        return float(torch.mean(
            (torch.argmax(mlp_apply(params, xb), -1) == yb).float()))

    train_acc = acc(Xtr, ytr)
    test_acc = acc(Xte, yte)

    @torch.no_grad()
    def predict(addrs_np):
        xb = torch.from_numpy(page_bits(addrs_np, granularity, n_bits)
                              ).to(device)
        return torch.argmax(mlp_apply(params, xb), -1).cpu().numpy()

    return FitResult(params, train_acc, test_acc, predict, n_bits)
