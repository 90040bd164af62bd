"""Training loop (``repro.train.trainer`` in PyTorch): the train step
(loss, gradients, optional error-feedback compression, AdamW), fault
tolerance (auto-resume from the latest atomic checkpoint), the straggler
watchdog (step-time EMA), the loss history and periodic checkpoints.

With ``mesh=`` (a :class:`~repro_torch.dist.sharding.Mesh` over the
process group every rank of which builds its own ``Trainer``) the state is
sharded as the reference's jitted step shards it: the params from the same
seeded init as without a mesh, placed by ``param_pspecs``; the moments by
``zero1_pspecs`` (the data axis as well); the error feedback as the
params; each batch over the batch axes. The step runs on DTensors under
``use_mesh``, plain tensors (positions, masks) counting as replicated.
A resume restores onto the current mesh (``restore(shardings=...)``),
whatever mesh, if any, wrote the checkpoint.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional

import torch

from . import checkpoint as ckpt
from .compression import ef_compress_tree, init_error_feedback
from .data import DataConfig, device_batch
from .optimizer import (AdamWConfig, OptState, adamw_update, init_opt_state,
                        zero1_pspecs)
from .tree import leaves, unflatten
from ..configs.base import ModelConfig
from ..dist.sharding import PSpec, distribute, param_pspecs, use_mesh
from ..models import io as model_io
from ..models import transformer as tf


@dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    compress_grads: bool = False
    zero1: bool = True
    straggler_factor: float = 3.0   # step slower than EMA*factor => flagged
    donate: bool = True


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    compress: bool = False, donate: bool = False):
    """step_fn(params, opt_state, err, batch) -> (params, opt_state, err,
    metrics): the loss's gradients with respect to every param leaf,
    compressed with error feedback when ``compress``, then AdamW (in place
    when ``donate``)."""
    def step_fn(params, opt_state, err, batch):
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                loss, metrics = tf.loss_fn(params, cfg, batch)
                if hasattr(loss, "full_tensor"):       # sharded: a DTensor
                    loss = loss.full_tensor()
                    metrics = {k: getattr(v, "full_tensor", lambda: v)()
                               for k, v in metrics.items()}
                # a leaf the loss does not reach (whisper's ungated
                # cross blocks' gate) gets a zero gradient, as in JAX
                grads = unflatten(params, torch.autograd.grad(
                    loss, flat, materialize_grads=True))
        finally:
            for p in flat:
                p.requires_grad_(False)
        metrics = {k: v.detach() for k, v in metrics.items()}
        if compress:
            grads, err = ef_compress_tree(grads, err)
        params, opt_state, om = adamw_update(opt_cfg, grads, opt_state,
                                             params, donate=donate)
        return params, opt_state, err, {**metrics, **om}
    return step_fn


class Trainer:
    def __init__(self, cfg: ModelConfig, data_cfg: DataConfig,
                 opt_cfg: AdamWConfig, tcfg: TrainerConfig, mesh=None,
                 seed: int = 0, device="cuda"):
        self.cfg, self.data_cfg, self.opt_cfg, self.tcfg = (
            cfg, data_cfg, opt_cfg, tcfg)
        self.device = torch.device(device)
        self.mesh = mesh
        self.step = 0
        self.straggler_events: list = []
        self.history: list = []
        self._step_fn = make_train_step(cfg, opt_cfg, tcfg.compress_grads,
                                        tcfg.donate)
        params = tf.init_params(cfg, seed, self.device)
        opt = init_opt_state(params)
        err = init_error_feedback(params)
        self.batch_sharding = None
        self._specs = None
        if mesh is not None:
            if mesh.device_type != self.device.type:
                raise ValueError(f"a {mesh.device_type} mesh cannot train "
                                 f"on {self.device}")
            from ..launch.specs import batch_pspec
            pspecs = param_pspecs(params, mesh)
            ospecs = zero1_pspecs(params, mesh, tcfg.zero1)
            params = distribute(params, pspecs)
            opt = OptState(distribute(opt.m, ospecs.m),
                           distribute(opt.v, ospecs.v), opt.count)
            err = distribute(err, pspecs)
            self.batch_sharding = {
                n: PSpec(mesh, (batch_pspec(mesh, shp[0]),))
                for n, shp, _ in model_io.batch_fields(
                    cfg, data_cfg.global_batch, data_cfg.seq_len)}
            # the count stays a plain tensor (replicated)
            self._specs = {"params": pspecs,
                           "opt": {"m": ospecs.m, "v": ospecs.v,
                                   "count": None},
                           "err": pspecs}
        self.params, self.opt_state, self.err = params, opt, err
        self._maybe_resume()

    # ------------------------------------------------------------------
    def _state_tree(self):
        return {"params": self.params, "opt": self.opt_state._asdict(),
                "err": self.err}

    def _maybe_resume(self):
        d = self.tcfg.ckpt_dir
        if not d:
            return
        step = ckpt.latest_step(d)
        if step is None:
            return
        tree, manifest = ckpt.restore(d, step, self._state_tree(),
                                      shardings=self._specs)
        self.params = tree["params"]
        self.opt_state = OptState(tree["opt"]["m"], tree["opt"]["v"],
                                  tree["opt"]["count"])
        self.err = tree["err"]
        self.step = manifest["meta"].get("next_step", step)

    def save(self):
        if self.tcfg.ckpt_dir:
            ckpt.save(self.tcfg.ckpt_dir, self.step, self._state_tree(),
                      meta={"next_step": self.step}, keep=self.tcfg.keep)

    # ------------------------------------------------------------------
    def run(self, steps: Optional[int] = None):
        steps = steps if steps is not None else self.tcfg.steps
        extra = [f for f in model_io.batch_fields(
            self.cfg, self.data_cfg.global_batch, self.data_cfg.seq_len)
            if f[0] not in ("tokens", "labels")]
        ema = None
        with _sharded(self.mesh):
            while self.step < steps:
                batch = device_batch(self.data_cfg, self.step, extra,
                                     self.device, self.mesh,
                                     self.batch_sharding)
                t0 = time.perf_counter()
                self.params, self.opt_state, self.err, metrics = \
                    self._step_fn(self.params, self.opt_state, self.err,
                                  batch)
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t0
                if ema is not None and dt > self.tcfg.straggler_factor * ema:
                    self.straggler_events.append((self.step, dt, ema))
                ema = dt if ema is None else 0.9 * ema + 0.1 * dt
                self.history.append({"step": self.step, "loss": loss,
                                     "time_s": dt})
                self.step += 1
                if (self.tcfg.ckpt_dir
                        and self.step % self.tcfg.ckpt_every == 0):
                    self.save()
        if self.tcfg.ckpt_dir:
            self.save()
        return self.history


@contextmanager
def _sharded(mesh):
    """``use_mesh(mesh)`` with plain tensors counting as replicated
    DTensors; nothing without a mesh."""
    if mesh is None:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    with use_mesh(mesh), implicit_replication():
        yield
