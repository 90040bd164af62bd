"""Sharded training cases of ``tests/test_torch_train.py``, each side in a
subprocess of its own (no process group, and no forced XLA device count,
outlives it):

- ``python _torch_dist_cases.py port IN OUT``: 4 gloo ranks
  (``repro_torch.launch.mesh.run_local``) run the port's sharded trainer
  on a (data=2, model=2) mesh, restore an unsharded checkpoint onto that
  mesh and resume from it, and take ``compressed_cross_pod_mean`` over a
  2-rank pod axis;
- ``python _torch_dist_cases.py ref IN OUT``: the reference's sharded
  ``Trainer`` on a (2, 2) mesh of 4 fake XLA CPU devices, from the port's
  weights.

IN and OUT are pickle files: IN holds the case's settings (and the
weights), OUT the results.
"""
import os
import pickle
import sys

import numpy as np

STEPS = 3
MESH = (2, 2)


def _trainer_args(case):
    from repro_torch.configs import smoke_config
    from repro_torch.train import AdamWConfig, DataConfig, TrainerConfig
    cfg = smoke_config(case["arch"])
    dc = DataConfig(cfg.vocab_size, case["seq"], case["batch"],
                    seed=case["seed"])
    return cfg, dc, AdamWConfig(**case["opt"])


def port_rank(rank, case):
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.compression import (compressed_cross_pod_mean,
                                               dequantize, quantize_int8)
    from repro_torch.train.tree import leaves
    out = {}
    cfg, dc, oc = _trainer_args(case)
    mesh = make_mesh(MESH, ("data", "model"))
    tr = Trainer(cfg, dc, oc, TrainerConfig(steps=STEPS), seed=case["seed"],
                 device="cpu", mesh=mesh)
    out["losses"] = [h["loss"] for h in tr.run()]
    out["placements"] = {k: str(tuple(v.placements)) for k, v in
                         (("embed", tr.params["embed"]),
                          ("m_embed", tr.opt_state.m["embed"]))}
    # the unsharded checkpoint restored onto the mesh, leaf for leaf
    d = case["ckpt_dir"]
    step = ckpt.latest_step(d)
    plain, _ = ckpt.restore(d, step, tr._state_tree())
    sharded, _ = ckpt.restore(d, step, tr._state_tree(),
                              shardings=tr._specs)
    out["restore_equal"] = all(
        torch.equal(b.full_tensor() if hasattr(b, "full_tensor") else b, a)
        for a, b in zip(leaves(plain), leaves(sharded)))
    out["restore_dtensors"] = sum(hasattr(x, "placements")
                                  for x in leaves(sharded))
    out["restore_leaves"] = len(leaves(sharded))
    # resumed on the mesh from that checkpoint
    tr2 = Trainer(cfg, dc, oc, TrainerConfig(steps=case["resume_to"],
                                             ckpt_dir=d,
                                             ckpt_every=10 ** 6),
                  seed=case["seed"], device="cpu", mesh=mesh)
    out["resumed_at"] = tr2.step
    tr2.tcfg.ckpt_dir = None                # leave the directory as it was
    out["resumed"] = [h["loss"] for h in tr2.run()]
    # the int8 cross-pod mean over pod=2 (ranks sharing a data coordinate)
    pod = make_mesh(MESH, ("pod", "data"))
    g = {"w": torch.randn(6, 5, generator=torch.Generator().manual_seed(
        100 + rank)), "b": [torch.randn(7, generator=torch.Generator()
                                        .manual_seed(200 + rank))]}
    mean = compressed_cross_pod_mean(g, "pod", mesh=pod)
    out["pod_mean"] = [x.numpy() for x in leaves(mean)]
    out["pod_deq"] = [dequantize(*quantize_int8(x)).numpy()
                      for x in leaves(g)]
    return out


def port(case):
    from repro_torch.launch.mesh import run_local
    return run_local(int(np.prod(MESH)), port_rank, case, threads=2)


def ref(case):
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={int(np.prod(MESH))}")
    import jax
    import jax.numpy as jnp
    from repro import train as jtrain
    from repro.configs import smoke_config
    from repro.dist.sharding import param_pspecs
    from repro.launch.mesh import make_mesh
    cfg = smoke_config(case["arch"])
    mesh = make_mesh(MESH, ("data", "model"))
    jt = jtrain.Trainer(
        cfg, jtrain.DataConfig(cfg.vocab_size, case["seq"], case["batch"],
                               seed=case["seed"]),
        jtrain.AdamWConfig(**case["opt"]),
        jtrain.TrainerConfig(steps=STEPS), mesh=mesh)
    params = jax.tree.map(jnp.asarray, case["params"])
    jt.params = jax.device_put(params, param_pspecs(params, mesh))
    jt.opt_state = jtrain.optimizer.init_opt_state(jt.params)
    return {"losses": [h["loss"] for h in jt.run()],
            "spec_embed": str(param_pspecs(params, mesh)["embed"].spec)}


if __name__ == "__main__":
    side, src, dst = sys.argv[1:4]
    with open(src, "rb") as f:
        case = pickle.load(f)
    res = {"port": port, "ref": ref}[side](case)
    with open(dst, "wb") as f:
        pickle.dump(res, f)
