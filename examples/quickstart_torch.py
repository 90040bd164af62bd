"""Quickstart on the PyTorch/CUDA port: the three faces of the framework.

  1. train a reduced LM for a few steps (loss goes down),
  2. reverse-engineer a simulated GPU's VRAM channel hash and fit the MLP,
  3. serve one LS + one BE tenant through the continuous-batching engine
     with SGDRC isolation (coloring + a ResourcePlan's BE quantum share)
     and print per-class p99s.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
      (the card by default; --device cpu trains, fits and serves on the CPU)
"""
import argparse

import numpy as np

from repro_torch.configs import smoke_config
from repro_torch.core.coloring import (VRAMDevice, collect_samples,
                                       fit_channel_hash, gpu_hash_model)
from repro_torch.core.controller import grid_search
from repro_torch.core.simulator import GPU_DEVICES
from repro_torch.core.tenancy import TenantSpec
from repro_torch.serving import ServingEngine
from repro_torch.train import AdamWConfig, DataConfig, Trainer, TrainerConfig

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
args = ap.parse_args()

# -- 1. train ---------------------------------------------------------------
cfg = smoke_config("qwen3-1.7b").replace(num_layers=2)
dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8)
trainer = Trainer(cfg, dc, AdamWConfig(lr=1e-3, warmup_steps=3,
                                       total_steps=30),
                  TrainerConfig(steps=15), device=args.device)
hist = trainer.run()
print(f"[train] loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} "
      f"over {len(hist)} steps")
assert hist[-1]["loss"] < hist[0]["loss"]

# -- 2. reverse-engineer + fit the channel hash ------------------------------
hm = gpu_hash_model("rtx-a2000")
dev = VRAMDevice(hm, seed=1)
res = collect_samples(dev, 2 << 20, 400, seed=0)
fit = fit_channel_hash(res.addrs[res.labels >= 0],
                       res.labels[res.labels >= 0], hm.granularity,
                       res.num_channels_found, steps=800, hidden=96, depth=5,
                       n_bits=12, device=args.device)
print(f"[reveng] found {res.num_channels_found} channels "
      f"(true {hm.num_channels}), probe acc {res.label_accuracy:.3f}, "
      f"MLP test acc {fit.test_acc:.3f}")

# -- 3. serve LS + BE with SGDRC isolation -----------------------------------
# offline: grid-search the (SM_BE, Ch_BE, Thres_DRAM) plan on a device model;
# online: the engine lends BE the plan's quantum share and colors KV arenas.
plan = grid_search(GPU_DEVICES["rtx-a2000"],
                   [smoke_config("stablelm-1.6b")],
                   [smoke_config("gemma2-9b")], pairs_per_model=1)
eng = ServingEngine(max_seq=24, coloring=True, hash_model=hm, plan=plan,
                    arena_bytes=8 << 20, slots_ls=3, slots_be=2,
                    torch_device=args.device)
eng.add_tenant(TenantSpec("ls", "LS", nice=10_000, slo_ms=60_000.0),
               smoke_config("stablelm-1.6b").replace(
                   num_layers=1, activation_dtype="float32"))
eng.add_tenant(TenantSpec("be", "BE", nice=1),
               smoke_config("gemma2-9b").replace(
                   num_layers=2, activation_dtype="float32"))
rng = np.random.default_rng(0)
for _ in range(3):
    eng.submit("ls", rng.integers(0, 100, 6), max_new=3)
    eng.submit("be", rng.integers(0, 100, 6), max_new=3)
eng.run_until_idle()
m = eng.metrics()
print(f"[serve] plan SM_BE={plan.sm_be:.2f} Ch_BE={plan.ch_be:.2f} | "
      f"LS p99 {m['_class']['LS']['p99_ms']:.0f} ms "
      f"(SLO attainment {m['_class']['LS']['slo_attainment']:.0%}) | "
      f"BE p99 {m['_class']['BE']['p99_ms']:.0f} ms | "
      f"coloring violations: "
      f"{sum(v['violations'] for v in m['_coloring'].values())}")
print("quickstart OK")
