"""End-to-end run of the PyTorch/CUDA port (the paper's kind of system
is a server): multi-tenant DNN inference with batched requests, comparing
SGDRC against the baseline GPU-sharing policies on the full-size assigned
architectures (sim backend) AND running the reduced models for real with
continuous batching (torch backend, on the card) — both through the SAME
ServingEngine API, with the offline controller's ResourcePlan threaded
into each. The sim rows depend on neither weights nor the wall clock.

Run:  PYTHONPATH=src python examples/serve_multitenant_torch.py
      (add --trace to attach the telemetry plane to the sgdrc+online run
      and print its SLO-timeline violation-attribution table; --device cpu
      serves the real-execution part on the CPU)
"""
import argparse
import json

import numpy as np

from repro_torch import obs
from repro_torch.configs import get_config, smoke_config
from repro_torch.core.controller import (OnlineController, grid_search,
                                         tidal_frontier)
from repro_torch.core.coloring import gpu_hash_model
from repro_torch.core.simulator import TPU_V5E, poisson_trace
from repro_torch.core.tenancy import TenantSpec
from repro_torch.serving import ServingEngine

ap = argparse.ArgumentParser()
ap.add_argument("--trace", action="store_true")
ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
args = ap.parse_args()

HORIZON = 5.0

# -- offline phase: derive the ResourcePlan once ----------------------------
plan = grid_search(TPU_V5E, [smoke_config("qwen3-1.7b")],
                   [smoke_config("gemma2-9b")], pairs_per_model=2)
print(f"plan: SM_BE={plan.sm_be:.2f} Ch_BE={plan.ch_be:.2f} "
      f"Thres_DRAM={plan.thres_dram:.2f}")

# -- pod-scale what-if on the full configs (sim backend) --------------------
# "sgdrc+online" adds the online control plane on top of full SGDRC: a
# tidal controller over the plan's two-point frontier re-plans sm_be/ch_be
# every 5 simulated ms, lending BE the whole machine between LS arrivals
print(f"\n{'policy':<22s} {'LS p99 (ms)':>12s} {'BE thpt (samp/s)':>18s}")
for policy, coloring, online in [("temporal", False, False),
                                 ("spatial", False, False),
                                 ("orion", False, False),
                                 ("sgdrc", False, False),
                                 ("sgdrc", True, False),
                                 ("sgdrc", True, True)]:
    ctrl = OnlineController(tidal_frontier(plan)) if online else None
    # --trace: attach the telemetry plane to the sgdrc+online row and give
    # the LS tenants an SLO so request:done events carry verdicts the
    # SLOTimeline can score and attribute
    tracer = obs.Tracer("info") if (args.trace and online) else None
    ls_slo = 15.0 if tracer is not None else None
    eng = ServingEngine(backend="sim", device="tpu-v5e", policy=policy,
                        coloring=coloring, plan=plan, controller=ctrl,
                        control_dt=0.005, tracer=tracer)
    eng.add_tenant(TenantSpec("ls0", "LS", batch_size=1, slo_ms=ls_slo),
                   get_config("qwen3-1.7b"), sim_seq=128)
    eng.add_tenant(TenantSpec("ls1", "LS", batch_size=1, slo_ms=ls_slo),
                   get_config("qwen3-1.7b"), sim_seq=128)
    eng.add_tenant(TenantSpec("be0", "BE", batch_size=8),
                   get_config("gemma2-9b"), closed_loop=True, sim_seq=256)
    for i, name in enumerate(("ls0", "ls1")):
        for t in poisson_trace(30, HORIZON, i + 1):
            eng.submit(name, np.zeros(1, np.int32), max_new=0, at=t)
    eng.run_until_idle(horizon=HORIZON)
    res = eng.sim_result
    tag = policy + ("+coloring" if coloring else "") + \
        ("+online" if online else "")
    print(f"{tag:<22s} {res.ls_p99()*1e3:>12.1f} "
          f"{res.be_throughput(8):>18.1f}")
    if tracer is not None:
        tl = obs.SLOTimeline(tracer.events, window=HORIZON / 10)
        print(f"\nSLO timeline ({tag}, {tracer.stats()['events']} events, "
              f"LS SLO {ls_slo:.0f}ms): violation attribution")
        print(tl.format_table())
        print()

# -- real execution at reduced scale (torch backend) -------------------------
# paged colored KV + radix-tree prefix cache: the repeated system prompt is
# prefilled once and shared copy-on-write into later slots' page tables
print("\nreal-torch reduced-scale continuous-batching serving "
      "(plan-driven BE quantum share + online tidal re-planning "
      "+ prefix-cache page sharing):")
ctrl = OnlineController(tidal_frontier(plan, 12), idle_patience=1)
eng = ServingEngine(max_seq=20, coloring=True, plan=plan,
                    hash_model=gpu_hash_model("tesla-p40"),
                    arena_bytes=8 << 20, slots_ls=4, slots_be=2,
                    paged=True, page_size=4, prefix_cache=True,
                    controller=ctrl, control_interval=2,
                    torch_device=args.device)
eng.add_tenant(TenantSpec("ls:qwen3", "LS", nice=10_000),
               smoke_config("qwen3-1.7b").replace(
                   num_layers=2, activation_dtype="float32"))
eng.add_tenant(TenantSpec("be:gemma2", "BE", nice=1),
               smoke_config("gemma2-9b").replace(
                   num_layers=2, activation_dtype="float32"))
rng = np.random.default_rng(0)
system_prompt = rng.integers(0, 200, 4)
for i in range(4):
    eng.submit("ls:qwen3",
               np.concatenate([system_prompt, rng.integers(0, 200, 2)]),
               max_new=4)
    eng.submit("be:gemma2",
               np.concatenate([system_prompt, rng.integers(0, 200, 2)]),
               max_new=4)
    eng.run_until_idle()
print(json.dumps(eng.metrics(), indent=1))
print(f"online transitions: {len(eng.transitions)} "
      f"(pages moved: {sum(t['pages_moved'] for t in eng.transitions)}, "
      f"migrated bytes: {eng.migrated_bytes})")

# -- KV memory hierarchy: growth + host-tier page swap -----------------------
# a deliberately tiny page pool oversubscribes the arena: requests admit on
# prompt-extent pages only, grow page-by-page while decoding, and on
# exhaustion cold decode page groups swap to a quantized (int8) host tier
# over the PCIe CFS instead of being recomputed from scratch
print("\nKV hierarchy under an oversubscribed pool "
      "(--grow-pages --swap --cold-dtype int8 in the launcher):")
eng = ServingEngine(max_seq=20, paged=True, page_size=4, kv_pages=10,
                    grow_pages=True, swap=True, cold_dtype="int8",
                    slots_ls=8, slots_be=8, torch_device=args.device)
eng.add_tenant(TenantSpec("be:gemma2", "BE"),
               smoke_config("gemma2-9b").replace(
                   num_layers=2, activation_dtype="float32"))
rng = np.random.default_rng(1)
reqs = [eng.submit("be:gemma2", rng.integers(0, 200, 8), max_new=10)
        for _ in range(6)]
eng.run_until_idle()
m = eng.metrics()["be:gemma2"]
print(f"peak concurrent slots: {m['peak_active']} "
      f"(vs {10 * 4 // 20} with full-extent reservation on the same pool)")
print("swap:", json.dumps(m["swap"], indent=1))
