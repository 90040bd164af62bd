"""Multi-pod dry run (``repro.launch.dryrun`` on DTensor): trace one step of
every (architecture x input-shape) cell on the production meshes (16x16
single-pod, 2x16x16 multi-pod), each rank's view, and record memory, FLOP
and collective metrics.

The reference lowers and compiles each cell on 512 fake XLA devices. Here a
fake process group of 256 or 512 ranks lives in this one process
(``launch.mesh.fake_group``), the cell's params, optimizer state, batch and
cache are meta DTensors placed by the reference's rules, and the step runs
once under :func:`~repro_torch.launch.hlo_metrics.traced_metrics`: shapes
and collectives are real, values are never computed, nothing is allocated.

The reference's probes (small unrolled models whose metrics are scaled up,
because XLA's cost analysis counts a ``scan`` body once) have no use here:
the port has no scan, so the trace counts every layer and every SSM chunk.
A record's ``scaled`` field is therefore the traced totals themselves, and
no ``ssm_correction`` is applied; ``--no-probes`` is accepted and changes
nothing.

Every placement inside a model block is stated
(``repro_torch.dist.sharding``), so the trace is a function of the tree,
not of the installed torch's sharding rules: ``tests/torch_dryrun_pins.json``
pins the smoke cells (``SMOKE_CELLS``, each on both ``SMOKE_MESHES``) and
six full-width cells (``PIN_CELLS``), and ``chip_smoke.py`` phase 16c
holds the GPU machine's torch to it. A record names the torch that traced
it. ``--grid`` traces the reference's whole applicable grid, one
subprocess a run, several at once, into one file
(``tests/torch_dryrun_grid.json``), beside which
``tests/_dryrun_reference.py --grid`` writes the reference's compiled
values.

Usage:
    python -m repro_torch.launch.dryrun                  # all cells, both meshes
    python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape decode_32k
    python -m repro_torch.launch.dryrun --mesh multi --force
    python -m repro_torch.launch.dryrun --smoke FILE     # the smoke cells
    python -m repro_torch.launch.dryrun --pins FILE      # write the pins
    python -m repro_torch.launch.dryrun --grid FILE --jobs 6   # every run
Artifacts: artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json  (resumable)
"""
import argparse
import json
import os
import time
import traceback

from ..configs import SHAPES, dryrun_cells, get_config
from ..configs.base import ModelConfig, ShapeConfig
from ..train.optimizer import AdamWConfig

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "artifacts", "dryrun_torch")

# the smoke cells: six architectures at smoke widths on two 8-rank
# meshes ("<mesh>/<arch>/<kind>": mesh dims and axes, arch, shape)
SMOKE_MESHES = {"single": ((2, 4), ("data", "model")),
                "multi": ((2, 2, 2), ("pod", "data", "model"))}
_TRAIN, _DECODE = ShapeConfig("t", 64, 8, "train"), \
    ShapeConfig("d", 64, 8, "decode")
SMOKE_CELLS = (("qwen3-1.7b", _TRAIN),
               ("deepseek-v2-236b", _DECODE),
               ("zamba2-1.2b", ShapeConfig("p", 64, 8, "prefill")),
               ("whisper-small", _TRAIN), ("whisper-small", _DECODE),
               ("llama-3.2-vision-90b", _TRAIN),
               ("llama-3.2-vision-90b", _DECODE),
               ("rwkv6-7b", _TRAIN), ("zamba2-1.2b", _TRAIN))
# the full-width cells pinned beside them (arch, shape, mesh)
PIN_CELLS = (("qwen3-1.7b", "train_4k", "single"),
             ("deepseek-v2-236b", "decode_32k", "multi"),
             ("llama-3.2-vision-90b", "decode_32k", "multi"),
             ("rwkv6-7b", "train_4k", "single"),
             ("whisper-small", "train_4k", "single"),
             ("zamba2-1.2b", "train_4k", "single"))


# a cell fits one H100 when its per-device argument and temp bytes
# together stay under the card's 80 GB
H100_BYTES = 80e9


def fits(argument_bytes: float, temp_bytes: float) -> bool:
    """The fits-in-80-GB verdict of a cell's per-device bytes."""
    return argument_bytes + temp_bytes < H100_BYTES


def cell_mode(shape: ShapeConfig) -> str:
    return {"train": "train", "prefill": "prefill", "decode": "decode"}[
        shape.kind]


def tune_config(cfg: ModelConfig, mode: str, *, probe: bool = False,
                overrides: dict | None = None) -> ModelConfig:
    import dataclasses as _dc
    from ..core.costmodel import param_count
    big = param_count(cfg) > 2e10
    kw = dict(scan_layers=not probe)
    if mode == "train":
        kw.update(param_dtype="float32", activation_dtype="bfloat16",
                  remat="full" if big else "dots")
    else:
        kw.update(param_dtype="bfloat16", activation_dtype="bfloat16",
                  remat="none")
    if overrides:
        ov = dict(overrides)
        if "capacity_factor" in ov and cfg.moe:
            kw["moe"] = _dc.replace(cfg.moe,
                                    capacity_factor=float(ov.pop("capacity_factor")))
        kw.update(ov)
    return cfg.replace(**kw)


def place_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, mode: str):
    """(step, args): the cell's step function and its arguments as meta
    DTensors on ``mesh``, placed by the reference's rules (params by
    ``param_pspecs``, moments by ``zero1_pspecs``, error feedback as the
    params, batches and caches by ``input_specs``). A decode step writes
    the cache's last slot (``pos = seq_len - 1``), so it attends over the
    whole window."""
    from ..dist.sharding import distribute
    from ..train.optimizer import OptState
    from .specs import abstract_state, input_specs, make_steps
    train_step, prefill_step, serve_step = make_steps(cfg, AdamWConfig())
    params, pspecs, opt, ospecs, err = abstract_state(cfg, mesh)
    params = distribute(params, pspecs)
    if mode == "train":
        opt = OptState(distribute(opt.m, ospecs.m),
                       distribute(opt.v, ospecs.v), opt.count)
        batch, bshards = input_specs(cfg, shape, mesh, "train")
        return train_step, (params, opt, distribute(err, pspecs),
                            distribute(batch, bshards))
    if mode == "prefill":
        batch, bshards = input_specs(cfg, shape, mesh, "prefill")
        return prefill_step, (params, distribute(batch, bshards))
    (token, cache, extras), (tsh, csh, esh) = input_specs(
        cfg, shape, mesh, "decode")
    return serve_step, (params, distribute(token, tsh),
                        distribute(cache, csh), shape.seq_len - 1,
                        distribute(extras, esh))


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, mode: str):
    """Trace the cell's step once on ``mesh``; returns
    ``traced_metrics``'s dict (per device)."""
    from torch.distributed.tensor.experimental import implicit_replication
    from ..dist.sharding import use_mesh
    from .hlo_metrics import traced_metrics
    with use_mesh(mesh), implicit_replication():
        step, args = place_cell(cfg, shape, mesh, mode)
        metrics, _ = traced_metrics(step, *args)
    return metrics


def summary(m: dict) -> dict:
    """What the pins hold of a traced cell: FLOPs, argument and temp
    bytes, collective counts by kind."""
    return {"flops": m["flops"],
            "argument_bytes": m["memory"]["argument_bytes"],
            "temp_bytes": m["memory"]["temp_bytes"],
            "collectives": dict(sorted(m["collectives"]["counts"].items()))}


def trace_smoke(meshes=tuple(SMOKE_MESHES)) -> dict:
    """Trace the SMOKE_CELLS on each of ``meshes`` (names of
    SMOKE_MESHES), each on a fake process group of 8 ranks; returns
    ``traced_metrics``'s dict a cell, by "<mesh>/<arch>/<kind>"."""
    from ..configs import smoke_config
    from .mesh import fake_group, make_mesh
    out = {}
    for mesh_name in meshes:
        dims, axes = SMOKE_MESHES[mesh_name]
        with fake_group(8):
            mesh = make_mesh(dims, axes)
            for arch, shape in SMOKE_CELLS:
                cfg = tune_config(smoke_config(arch), shape.kind)
                out[f"{mesh_name}/{arch}/{shape.kind}"] = trace_cell(
                    cfg, shape, mesh, shape.kind)
    return out


def write_pins(path: str, argv) -> dict:
    """Trace the SMOKE_CELLS and the PIN_CELLS and write their summaries
    to ``path`` (JSON) with the command and the torch that wrote them,
    keeping the file's "reference" entry (the reference's compiled
    values, written by ``tests/_dryrun_reference.py``)."""
    import sys
    import tempfile
    import torch
    old = {}
    if os.path.exists(path):
        with open(path) as f:
            old = json.load(f)
    cells = {k: summary(m) for k, m in trace_smoke().items()}
    with tempfile.TemporaryDirectory() as d:
        for arch, shape, mesh in PIN_CELLS:
            rec = run_cell(arch, shape, mesh, out_dir=d, force=True)
            if not rec["ok"]:
                raise RuntimeError(f"{arch} {shape} {mesh}: {rec['error']}")
            cells[f"{mesh}/{arch}/{shape}"] = summary(rec["main"])
    pins = {"command": " ".join(["python -m repro_torch.launch.dryrun"]
                                + list(argv)),
            "torch": torch.__version__, "python": sys.version.split()[0],
            "cells": cells}
    if "reference" in old:
        pins["reference"] = old["reference"]
    with open(path, "w") as f:
        json.dump(pins, f, indent=1)
        f.write("\n")
    return pins


def grid_runs():
    """(arch, shape, mesh) of every run of the reference's applicable
    grid (``dryrun_cells``, both meshes), the slowest kinds first."""
    runs = [(cfg.name, shape.name, mk) for cfg, shape, ok, _ in dryrun_cells()
            if ok for mk in ("single", "multi")]
    first = {"train": 0, "prefill": 1, "decode": 2}
    return sorted(runs, key=lambda r: (first[SHAPES[r[1]].kind],
                                       r[2] != "multi"))


def _grid_run(run, out_dir: str, env: dict):
    """Trace one (arch, shape, mesh) run of the grid in a subprocess of its
    own; returns ("<mesh>/<arch>/<shape>", its :func:`summary` with
    ``ok`` and ``elapsed_s``, or its error)."""
    import subprocess
    import sys
    arch, shape, mesh = run
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", mesh, "--out", out_dir, "--force"],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    path = os.path.join(out_dir, f"{arch}__{shape}__{mesh}.json")
    if os.path.exists(path):
        with open(path) as f:
            r = json.load(f)
    else:
        r = {"ok": False, "elapsed_s": None,
             "error": f"exit {proc.returncode}: {proc.stderr[-400:]}"}
    key = f"{mesh}/{arch}/{shape}"
    print(f"{'ok' if r['ok'] else 'FAIL':5s} {key:40s} ({r['elapsed_s']} s)",
          flush=True)
    return key, ({"ok": True, "elapsed_s": r["elapsed_s"],
                  **summary(r["main"])} if r["ok"] else
                 {"ok": False, "elapsed_s": r["elapsed_s"],
                  "error": r["error"]})


def write_grid(path: str, argv, jobs: int) -> dict:
    """Trace every run of :func:`grid_runs`, each in a subprocess of its
    own (``jobs`` at once, one thread each), and write each one's
    :func:`summary` (or its error: a run that cannot be traced is a
    ``FAIL`` entry, never left out) to ``path`` (JSON) with the command
    and the torch that wrote them, keeping the file's "reference" entry
    (``tests/_dryrun_reference.py --grid``)."""
    import sys
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    import torch
    old = {}
    if os.path.exists(path):
        with open(path) as f:
            old = json.load(f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    t0 = time.time()
    with tempfile.TemporaryDirectory() as d, ThreadPoolExecutor(jobs) as ex:
        cells = dict(ex.map(lambda run: _grid_run(run, d, env), grid_runs()))
    grid = {"command": " ".join(["python -m repro_torch.launch.dryrun"]
                                + list(argv)),
            "torch": torch.__version__, "python": sys.version.split()[0],
            "wall_s": round(time.time() - t0, 1),
            "cells": dict(sorted(cells.items()))}
    if "reference" in old:
        grid["reference"] = old["reference"]
    with open(path, "w") as f:
        json.dump(grid, f, indent=1)
        f.write("\n")
    n_ok = sum(c["ok"] for c in cells.values())
    print(f"\n{n_ok}/{len(cells)} runs traced in {grid['wall_s']} s")
    return grid


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             probes: bool = True, out_dir: str = ART_DIR,
             force: bool = False, overrides: dict | None = None,
             tag: str = "") -> dict:
    from .mesh import fake_group, make_production_mesh
    os.makedirs(out_dir, exist_ok=True)
    fname = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_kind}{tag}.json")
    if os.path.exists(fname) and not force:
        with open(fname) as f:
            return json.load(f)
    shape = SHAPES[shape_name]
    base = get_config(arch)
    mode = cell_mode(shape)
    n_dev = 512 if mesh_kind == "multi" else 256
    import torch
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "mode": mode, "n_devices": n_dev, "ok": False, "tag": tag,
           "torch": torch.__version__}
    t0 = time.time()
    try:
        with fake_group(n_dev):
            mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
            cfg = tune_config(base, mode, overrides=overrides)
            m = trace_cell(cfg, shape, mesh, mode)
        rec["main"] = m
        rec["n_periods"] = ((base.num_layers - base.n_prefix)
                            / base.probe_period)
        coll = m["collectives"]
        rec["scaled"] = {
            "flops": m["flops"], "bytes_accessed": m["bytes_accessed"],
            "collective_wire_bytes": coll["total_wire_bytes"],
            "collective_wire_bytes_by_kind": dict(coll["wire_bytes"])}
        rec["probes"] = "none: every layer and SSM chunk is traced"
        rec["ok"] = True
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["elapsed_s"] = round(time.time() - t0, 1)
    with open(fname, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--out", default=ART_DIR)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-probes", action="store_true",
                    help="accepted; the trace needs no probes")
    ap.add_argument("--tag", default="", help="artifact suffix (perf iters)")
    ap.add_argument("--attn-fallback", default="headdim",
                    choices=["headdim", "replicate"])
    ap.add_argument("--set", action="append", default=[],
                    help="cfg override k=v (e.g. remat=dots)")
    ap.add_argument("--smoke", default=None, metavar="FILE",
                    help="trace the smoke cells into FILE (JSON) and stop")
    ap.add_argument("--pins", default=None, metavar="FILE",
                    help="trace the smoke and pinned cells, write FILE")
    ap.add_argument("--grid", default=None, metavar="FILE",
                    help="trace every applicable run, write FILE")
    ap.add_argument("--jobs", type=int, default=4,
                    help="--grid: runs traced at once")
    args = ap.parse_args(argv)
    if args.grid:
        import sys
        return write_grid(args.grid, sys.argv[1:] if argv is None else argv,
                          args.jobs)
    if args.pins:
        import sys
        return write_pins(args.pins, sys.argv[1:] if argv is None else argv)
    if args.smoke:
        import torch
        out = {k: dict(summary(m), shapes=m["collectives"]["shapes"])
               for k, m in trace_smoke().items()}
        with open(args.smoke, "w") as f:
            json.dump({"torch": torch.__version__, "cells": out}, f,
                      indent=1)
        return out

    from ..dist.sharding import set_attn_fallback
    set_attn_fallback(args.attn_fallback)
    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = {"true": True, "false": False}.get(
            v.lower(), int(v) if v.isdigit() else v)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    results = []
    for cfg, shape, ok, why in dryrun_cells():
        if args.arch and cfg.name != args.arch:
            continue
        if args.shape and shape.name != args.shape:
            continue
        if not ok:
            print(f"SKIP  {cfg.name:24s} {shape.name:12s} -- {why}")
            continue
        for mk in meshes:
            t0 = time.time()
            rec = run_cell(cfg.name, shape.name, mk,
                           probes=not args.no_probes, out_dir=args.out,
                           force=args.force, overrides=overrides or None,
                           tag=args.tag)
            status = "ok" if rec["ok"] else "FAIL"
            mem = rec.get("main", {}).get("memory", {})
            print(f"{status:5s} {cfg.name:24s} {shape.name:12s} {mk:6s} "
                  f"args={mem.get('argument_bytes', 0)/2**30:8.2f}GiB/dev "
                  f"temp={mem.get('temp_bytes', 0)/2**30:7.2f}GiB/dev "
                  f"({time.time()-t0:6.1f}s)", flush=True)
            if not rec["ok"]:
                print("      " + rec["error"].splitlines()[0][:160], flush=True)
            results.append(rec)
    n_ok = sum(r["ok"] for r in results)
    print(f"\n{n_ok}/{len(results)} cells traced")
    return results


if __name__ == "__main__":
    main()
