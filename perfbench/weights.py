"""The benchmark's weights: made on the device from the seed, in the
program's parameter layout and the type they are served in.

One buffer holds every leaf of a model; it is filled with N(0, 1) draws by
a ``torch.Generator`` on the device in a few large calls, and each leaf, a
view of it, is then scaled in place: matrices by 1 / sqrt(fan-in), the
embedding by 1 / sqrt(d_model), the norms' gammas (RMSNorm's scale is
1 + gamma) by 0.1, so that a reference that got the norm's form wrong
would show. Two tenants of a seed draw from two generators.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

#: elements one fill call draws
CHUNK = 1 << 28


def layout(arch: dict) -> List[Tuple[str, tuple, float]]:
    """(path, shape, scale) of every leaf, in buffer order."""
    L, D, V = arch["num_layers"], arch["d_model"], arch["vocab_size"]
    H, Hkv, Dh, F = (arch["num_heads"], arch["num_kv_heads"],
                     arch["head_dim"], arch["d_ff"])
    leaves = [("embed", (V, D), D ** -0.5), ("final_ln", (D,), 0.1)]
    if not arch["tie_embeddings"]:
        leaves.append(("unembed", (D, V), D ** -0.5))
    s = "layers/s0/"
    leaves += [(s + "ln1", (L, D), 0.1), (s + "ln2", (L, D), 0.1),
               (s + "attn/wq", (L, D, H, Dh), D ** -0.5),
               (s + "attn/wk", (L, D, Hkv, Dh), D ** -0.5),
               (s + "attn/wv", (L, D, Hkv, Dh), D ** -0.5),
               (s + "attn/wo", (L, H, Dh, D), (H * Dh) ** -0.5)]
    if arch["qk_norm"]:
        leaves += [(s + "attn/q_gamma", (L, Dh), 0.1),
                   (s + "attn/k_gamma", (L, Dh), 0.1)]
    if arch["mlp_act"] == "swiglu":
        leaves.append((s + "mlp/w_gate", (L, D, F), D ** -0.5))
    leaves += [(s + "mlp/w_up", (L, D, F), D ** -0.5),
               (s + "mlp/w_down", (L, F, D), F ** -0.5)]
    return leaves


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def make(arch: dict, seed: int, tenant: int, device, dtype) -> Dict:
    """The weights of one tenant (``tenant`` 0 for LS, 1 for BE) as the
    program's nested dict of views into one buffer."""
    leaves = layout(arch)
    flat = torch.empty(sum(_numel(s) for _, s, _ in leaves), dtype=dtype,
                       device=device)
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + tenant) % 2 ** 63)
    for off in range(0, flat.numel(), CHUNK):
        flat[off:off + CHUNK].normal_(generator=g)
    tree: Dict = {}
    off = 0
    for path, shape, scale in leaves:
        n = _numel(shape)
        leaf = flat[off:off + n].view(shape)
        leaf.mul_(scale)
        off += n
        node = tree
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return tree
