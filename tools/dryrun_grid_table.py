#!/usr/bin/env python3
"""Print the dry-run grid (``tests/torch_dryrun_grid.json``) as the
markdown table of ``PERF.md``: one row a cell (architecture x shape),
each column "single; multi" (the 16x16 and 2x16x16 meshes).

Columns, per device, GiB: the reference's argument bytes, its temp as
compiled / its live peak / that less XLA's CPU copies of bf16 inputs
(``tests/_dryrun_reference.py``); the port's temp (``traced_metrics``);
port temp over the reference's as compiled and over its live peak; the
fits-in-80-GB verdicts (``repro_torch.launch.dryrun.fits``: argument +
temp under 80e9 B) as "reference compiled / reference less copies /
port", y or n; the port's collectives, all-reduce / all-gather /
reduce-scatter. A run the port could not trace reads FAIL.

    python3 tools/dryrun_grid_table.py [tests/torch_dryrun_grid.json]
"""
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))
from repro_torch.launch.dryrun import fits  # noqa: E402

GIB = 2 ** 30


def _fits(args, temp):
    return "y" if fits(args, temp) else "n"


def _mesh(got, ref):
    if not got.get("ok"):
        return None
    a, t = ref["argument_bytes"], ref["temp_bytes"]
    c = got["collectives"]
    return {
        "args": f"{a / GIB:.2f}",
        "ref": f"{t / GIB:.2f} / {ref['live_peak'] / GIB:.2f} / "
               f"{ref['live_peak_less_cpu_copies'] / GIB:.2f}",
        "port": f"{got['temp_bytes'] / GIB:.2f}",
        "ratio": f"{got['temp_bytes'] / t:.2f}",
        "live": f"{got['temp_bytes'] / ref['live_peak']:.2f}",
        "fits": f"{_fits(a, t)}/{_fits(a, ref['live_peak_less_cpu_copies'])}"
                f"/{_fits(got['argument_bytes'], got['temp_bytes'])}",
        "coll": "/".join(str(c.get(k, 0)) for k in
                         ("all-reduce", "all-gather", "reduce-scatter"))}


def main(path="tests/torch_dryrun_grid.json"):
    with open(path) as f:
        grid = json.load(f)
    ref = grid["reference"]["cells"]
    cells = sorted({tuple(k.split("/")[1:]) for k in grid["cells"]})
    print(f"Port: torch {grid['torch']}; reference: jax "
          f"{grid['reference']['jax']} (XLA on the CPU).\n")
    print("| Cell | Ref args | Ref temp / live / less copies | Port temp "
          "| Port / ref | Port / ref live | Fits: ref / less / port "
          "| Port AR/AG/RS |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- |")
    keys = ("args", "ref", "port", "ratio", "live", "fits", "coll")
    for arch, shape in cells:
        rows = [_mesh(grid["cells"][f"{m}/{arch}/{shape}"],
                      ref[f"{m}/{arch}/{shape}"]) for m in ("single", "multi")]
        cols = ["; ".join("FAIL" if r is None else r[k] for r in rows)
                for k in keys]
        print(f"| {arch} `{shape}` | " + " | ".join(cols) + " |")


if __name__ == "__main__":
    main(*sys.argv[1:])
