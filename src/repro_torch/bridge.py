"""Move the reference's state into the port: parameter and cache trees given
as numpy arrays (``jax.tree.map(np.asarray, tree)`` on the caller's side)
become tensors with the same structure — ``embed``, ``final_ln``, optional
``unembed``, the ``prefix`` list and the ``layers`` leaves stacked
``[n_periods, ...]`` for params (MoE layers' ``moe`` with its f32
``router``, ``experts`` ``w_gate``/``w_up`` ``[E, D, F]`` and ``w_down``
``[E, F, D]``, optional ``shared``; MLA layers' ``attn`` with ``wq_a``,
``q_ln``, ``wq_b``, ``wkv_a``, ``kv_ln``, ``wk_b``, ``wv_b``, ``wo``;
whisper's ``encoder`` and ``cross``); the same dicts of ``k``/``v``
leaves for dense caches ``[.., B, Hkv, S, Dh]`` and page pools ``[..,
n_pages, Hkv, page, Dh]``, and of MLA's ``ckv``/``krope`` latents ``[..,
B, S, R]`` and ``[.., n_pages, page, R]``. :func:`to_numpy` goes the
other way.
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: reinterpret the bits
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _convert(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _convert(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device, dtype) for v in tree]
    return _tensor(tree, device, dtype)


def params_from_numpy(tree, device, dtype=None):
    """Reference params (numpy leaves) -> tensors on ``device``; floating
    leaves cast to ``dtype`` when given (the serving engine holds weights
    in the activation dtype)."""
    return _convert(tree, device, dtype)


def cache_from_numpy(tree, device, dtype=None):
    """A dense cache (``init_cache``) or page-pool cache
    (``init_paged_cache``) of the reference, as numpy leaves -> tensors."""
    return _convert(tree, device, dtype)


def to_numpy(tree):
    """Tensors -> numpy (f32 for bf16 leaves), same structure."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
