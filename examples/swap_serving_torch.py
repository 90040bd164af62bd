"""Model-swapping scenario (paper §8.4): models live in host memory and
stream over the interconnect before serving; compare PCIe schedulers and
show the CFS nice-weight knob trading LS latency vs BE throughput — then
serve the swapped-in models through the continuous-batching ServingEngine
(cold-start swap -> plan-driven serving, end to end), on the PyTorch/CUDA
port. The swap tables are host models and depend on neither weights nor
the wall clock.

Run:  PYTHONPATH=src python examples/swap_serving_torch.py [--device cpu]
      (serves on the card by default)
"""
import argparse

import numpy as np

from repro_torch.configs import get_config, smoke_config
from repro_torch.core.pcie import (BusSpec, MultiStream, PCIeCFS, StreamBox,
                                   summarize)
from repro_torch.core.simulator import TPU_V5E, apollo_like_trace
from repro_torch.core.tenancy import TenantSpec
from repro_torch.serving import ServingEngine
from repro_torch.serving.swap import (model_bytes, pipelined_serve_time,
                                      swap_requests)

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
args = ap.parse_args()

HORIZON = 8.0
bus = BusSpec()
ls_archs = ["qwen3-1.7b", "stablelm-1.6b"]
be_archs = ["gemma2-9b"]

for arch in ls_archs + be_archs:
    mb = model_bytes(get_config(arch)) / 2**30
    t = pipelined_serve_time(get_config(arch), 1, 128, "prefill", TPU_V5E,
                             bus.bw_h2d)
    print(f"{arch:<18s} weights {mb:5.2f} GiB, cold-serve "
          f"(PipeSwitch overlap) {t*1e3:7.1f} ms")

print(f"\n{'scheduler':<14s} {'LS swap p99 (ms)':>17s} {'BE thpt':>10s}")
for name, sched, nice in [("multistream", MultiStream(), 1),
                          ("streambox", StreamBox(), 1),
                          ("cfs nice=1", PCIeCFS(2048), 1),
                          ("cfs nice=20", PCIeCFS(2048), 20),
                          ("cfs nice=10K", PCIeCFS(2048), 10_000)]:
    reqs, rid = [], 0
    for i, arch in enumerate(ls_archs):
        arr = apollo_like_trace(1.5, HORIZON, seed=i + 1)
        reqs += swap_requests(get_config(arch), f"ls:{arch}", "LS", nice, arr,
                              rid0=rid)
        rid += 100_000
    for arch in be_archs:
        arr = list(np.arange(0.0, HORIZON, 0.8))
        reqs += swap_requests(get_config(arch), f"be:{arch}", "BE", 100, arr,
                              rid0=rid)
        rid += 100_000
    comps = [c for c in sched.run(reqs, bus, "h2d") if c.t_done < HORIZON]
    p99, thpt, _ = summarize(comps)
    print(f"{name:<14s} {p99*1e3:>17.1f} {thpt/2**30:>8.2f}GiB/s")

# -- after the swap: serve the hot models through the batching engine --------
print("\nswapped-in models serving (continuous batching, reduced scale):")
eng = ServingEngine(max_seq=16, slots_ls=2, slots_be=2,
                    torch_device=args.device)
eng.add_tenant(TenantSpec("ls:qwen3", "LS", nice=10_000),
               smoke_config("qwen3-1.7b").replace(
                   num_layers=1, activation_dtype="float32"))
eng.add_tenant(TenantSpec("be:gemma2", "BE", nice=1),
               smoke_config("gemma2-9b").replace(
                   num_layers=2, activation_dtype="float32"))
rng = np.random.default_rng(1)
for _ in range(3):
    eng.submit("ls:qwen3", rng.integers(0, 200, 5), max_new=3)
    eng.submit("be:gemma2", rng.integers(0, 200, 5), max_new=3)
eng.run_until_idle()
m = eng.metrics()
for cls in ("LS", "BE"):
    c = m["_class"][cls]
    print(f"  {cls}: {c['completed']} done, p99 {c['p99_ms']:.0f} ms, "
          f"{c['tokens_per_s']:.1f} tok/s")
