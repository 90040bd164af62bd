#!/usr/bin/env python3
"""The readings the output check's limits are set from, in one process:
for each seed, one run of the cell (trace off, its own window and load)
and the widest gap of each tenant's served tokens below the float32
reference's best; on the first ``--control`` seeds also the control's
gap, the float8 reference's first choices at the same positions.

    python3 perfbench/tools/control.py --workload CELL \\
        --seeds 11,12,... [--control 3] [--seconds 20] [--out FILE]

Each seed's reading is one JSON line.
"""
import argparse
import time

from _common import emit, setup


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    cat = setup()
    from perfbench.harness import run_cell
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        res, run = run_cell(cat, args.workload, seed, args.seconds, False,
                            control=i < args.control)
        rec = {"kind": "check", "workload": args.workload, "seed": seed,
               "correct": res["correct"], "failed": res["failed"],
               "attempted": res["attempted"],
               "wall_s": time.perf_counter() - t}
        for cls, g in run.extra["gaps"].items():
            for k, v in g.items():
                rec[f"{cls.lower()}_{k}"] = v
        emit(args.out, rec)


if __name__ == "__main__":
    main()
