"""The port's benchmark: LS and BE tenants of ``repro_torch``'s serving
engine on one NVIDIA GPU under open-loop LS load and a closed BE backlog.

Everything that belongs to one configuration, traffic mix, cell or metric
lives in a file of its own (``configs/``, ``traffic/``, ``workloads/``,
``metrics/``), found by the name ``BENCHMARK.json`` gives it. Run one cell
with ``python3 perfbench/run.py --workload NAME --seed N --seconds S
--trace 0|1`` from the repository root.
"""
