"""Fault-tolerant checkpointing: atomic directory commits, async saves and
retention (``repro.train.checkpoint`` in PyTorch), in the reference's
on-disk format, so a checkpoint written by either package restores in the
other.

Layout:  <dir>/step_<N>/
            manifest.json       (step, leaf paths/shapes/dtypes, user meta)
            arrays.npz          (flat leaf arrays keyed by escaped path)
         <dir>/step_<N>.tmp...  (staging; renamed atomically on commit)

Leaves are keyed by their tree path (dict keys, list indices; an
``OptState`` is saved as its ``_asdict()``) joined with ``"|"``, in the
reference's flatten order (dict keys sorted). numpy has no bfloat16 of its
own, so a bf16 tensor is written as its f32 value (exact) and the manifest
records ``float32``, the dtype the file holds; ``restore`` casts every leaf
to the dtype of the matching leaf of ``like_tree`` (a bf16 leaf comes back
bit for bit). A reference checkpoint's bf16 arrays (``ml_dtypes``, read by
numpy as 2-byte voids where that package is absent) are read as bf16 bits.
The reference's resharded restore (``shardings=``, onto another mesh)
waits on the port's sharding layer: ``shardings`` must be None.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from .tree import leaves_with_paths, unflatten


def _flatten(tree):
    return {"/".join(path): leaf for path, leaf in leaves_with_paths(tree)}


def _to_numpy(x):
    """A leaf as a numpy array it owns (a copy: the caller may go on
    updating a tensor in place while an async save writes it)."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()
    return np.array(x)


def save(ckpt_dir: str, step: int, tree: Any, meta: Optional[dict] = None,
         keep: int = 3):
    """Atomic synchronous save."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = {k: _to_numpy(v) for k, v in _flatten(tree).items()}
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = {k.replace("/", "|"): v for k, v in flat.items()}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "leaves": {k: {"shape": list(np.shape(v)), "dtype": str(v.dtype)}
                   for k, v in flat.items()},
        "meta": meta or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)          # atomic commit
    _retain(ckpt_dir, keep)
    return final


class AsyncCheckpointer:
    """Overlaps checkpoint I/O with training (one in flight at a time)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, tree: Any, meta=None):
        self.wait()
        host_tree = unflatten(tree, [_to_numpy(x) for _, x in
                                     leaves_with_paths(tree)])
        self._thread = threading.Thread(
            target=save, args=(self.ckpt_dir, step, host_tree, meta, self.keep),
            daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def _retain(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _leaf(arr, like):
    """A stored array as a tensor: bf16 bits where the file holds them, on
    the device and in the dtype of ``like`` when it is a tensor."""
    if arr.dtype.name == "bfloat16" or (arr.dtype.kind == "V"
                                        and arr.dtype.itemsize == 2):
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, order="C"))
    if isinstance(like, torch.Tensor):
        t = t.to(device=like.device, dtype=like.dtype)
    return t


def restore(ckpt_dir: str, step: int, like_tree: Any, shardings=None):
    """Restore into the structure of ``like_tree`` (tensors, or arrays).
    Returns (tree of tensors, manifest)."""
    if shardings is not None:
        raise NotImplementedError(
            "restore(shardings=...) reshards onto a mesh; the port has no "
            "sharding layer yet (ROADMAP.md queue 1 item 5)")
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "arrays.npz"))
    out = []
    for k, like in _flatten(like_tree).items():
        arr = data[k.replace("/", "|")]
        assert list(arr.shape) == list(np.shape(like)), (k, arr.shape,
                                                         np.shape(like))
        out.append(_leaf(arr, like))
    return unflatten(like_tree, out), manifest


def restore_latest(ckpt_dir: str, like_tree: Any, shardings=None):
    step = latest_step(ckpt_dir)
    if step is None:
        return None, None
    return restore(ckpt_dir, step, like_tree, shardings)
