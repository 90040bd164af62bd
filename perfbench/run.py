#!/usr/bin/env python3
"""One run of one cell of the port's benchmark, on the machine it starts
on. From the repository's root:

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Prints one JSON line last on standard output (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
``kv_filled``: each tenant's KV pool and the most of it the traffic held,
and ``checks`` last: each number the output check compared, with its limit),
and those numbers again as the last lines of standard error. Exits non-zero
and prints no result without a CUDA device, with fewer devices than the
cell asks for, without the program's sources beside this directory, or
when a module of JAX or of the JAX package was loaded.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level modules that may not be loaded in the process that reports
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _err(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        _err(f"no program beside the benchmark: {ROOT / 'src'} lacks "
             "repro_torch")
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    # every build and kernel cache inside the checkout, at fixed paths
    cache = ROOT / "build" / "cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    import torch
    from perfbench.catalog import Catalog
    from perfbench.harness import run_cell
    cat = Catalog(ROOT)
    chips = cat.cell(args.workload)["chips"]
    if not torch.cuda.is_available():
        _err("no CUDA device: the benchmark measures the card only")
        return 3
    if torch.cuda.device_count() < chips:
        _err(f"{args.workload} needs {chips} devices, "
             f"{torch.cuda.device_count()} present")
        return 3
    _err(f"device: {torch.cuda.get_device_name(0)}, power limit "
         f"{_power_limit()}")
    res, _ = run_cell(cat, args.workload, args.seed, args.seconds,
                      bool(args.trace), device="cuda", t_process=T_PROCESS,
                      chips=chips)
    # whole top-level names, so that repro_torch is not repro
    bad = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if bad:
        _err("modules loaded that may not be: " + ", ".join(bad))
        return 4
    for cls, k in res["kv_filled"].items():
        _err(f"kv {cls}: {k['pages_peak']} of {k['pages_total']} pages "
             f"held at peak, {k['bytes_peak']} of {k['bytes_total']} bytes")
    for k, c in res["checks"].items():
        _err(f"{k} {c['value']} limit {c['limit']}")
    print(json.dumps(res), flush=True)
    return 0


def _power_limit() -> str:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "not read"


if __name__ == "__main__":
    sys.exit(main())
