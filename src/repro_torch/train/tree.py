"""Parameter and state trees (nested dicts and lists of tensors) in the
reference's flatten order: dict keys sorted, list items by index, as
``jax.tree_util`` orders them. Leaf paths are the keys and indices as
strings, which is how the checkpoint names its arrays."""
from __future__ import annotations


def leaves_with_paths(tree, prefix=()):
    """[(path tuple of str, leaf)] in the reference's flatten order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves_with_paths(tree[k], prefix + (str(k),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += leaves_with_paths(v, prefix + (str(i),))
        return out
    return [(prefix, tree)]


def leaves(tree):
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(like, flat):
    """``like``'s structure (its own key order) with its leaves replaced,
    in flatten order, by the items of ``flat``."""
    return _build(like, iter(flat))


def _build(t, it):
    # a module-level recursion: a nested one would be a reference cycle
    # (the function in its own closure) holding ``flat`` until the
    # garbage collector ran
    if isinstance(t, dict):
        vals = {k: _build(t[k], it) for k in sorted(t)}
        return {k: vals[k] for k in t}
    if isinstance(t, (list, tuple)):
        return [_build(v, it) for v in t]
    return next(it)

