"""The reference's dry-run cells compiled by XLA on the CPU, with the
buffers of each step's temp allocation read from XLA's dump, for
``tests/test_torch_dryrun.py`` and ``tests/torch_dryrun_pins.json``.

XLA's CPU backend has no bf16 dot: it gives each bf16 dot operand an f32
copy, and where that operand is one of the step's bf16 inputs (a layer
stack's weights, a cache), the copy is of the whole stacked input, made
before the layer loop and live through it (``cpu_copies``). No
accelerator's compile makes those, and neither does the port's eager
step. From XLA's own live ranges (the dump's ``HloLiveRange``), the
largest sum of temp buffers live at one point of the step is
``live_peak`` (``temp_bytes`` is the allocation, that plus
fragmentation), and ``live_peak_less_cpu_copies`` the same without
those copies.

Usage:
    python tests/_dryrun_reference.py ARCH SHAPE single|multi   # one cell
    python tests/_dryrun_reference.py --pins tests/torch_dryrun_pins.json
        # the reference's values for the pins' full-width cells
"""
import glob
import json
import os
import re
import sys
import tempfile

# the full-width cells whose reference values the pins keep
PIN_CELLS = (("qwen3-1.7b", "train_4k", "single"),
             ("deepseek-v2-236b", "decode_32k", "multi"))


def temp_buffers(dump: str) -> dict:
    """The step's temp allocation in an XLA dump directory: its size, its
    values (bytes, name, shape, live range, whether it is a CPU copy of a
    bf16 input live across a loop) and the live peaks with and without
    the copies."""
    bas = [f for f in glob.glob(os.path.join(dump, "*buffer-assignment.txt"))
           if re.search(r"jit_(step_fn|serve_step|prefill_step)", f)]
    ba = max(bas, key=os.path.getsize)
    hlo = open(ba.replace("-buffer-assignment.txt", ".txt")).read()
    params = {m.group(1): m.group(2) for m in re.finditer(
        r"%(param[\w.]*) = (\w+)\[", hlo)}
    converts = {m.group(1) for m in re.finditer(
        r"%(wrapped_convert[\w.]*) = f32\[[^\]]*\]\S* fusion\(%(param[\w.]*)"
        r"\)", hlo) if params.get(m.group(2)) == "bf16"}
    txt = open(ba).read()
    alloc = [a for a in re.split(r"\n(?=allocation \d+:)", txt)
             if "preallocated-temp" in a.split("\n")[0]][0]
    live = txt[txt.index("HloLiveRange"):]
    seq = dict((m.group(2), int(m.group(1))) for m in re.finditer(
        r"^\s+(\d+):(\S+)$", live, re.M))
    loops = [i for name, i in seq.items() if name.startswith("while")]
    ranges = {m.group(1): (int(m.group(2)), int(m.group(3)))
              for m in re.finditer(r"^\s+(\S+\{[\d,]*\}):(\d+)-(\d+)$",
                                   live, re.M)}
    vals = []
    for m in re.finditer(r"value: <\d+ (\S+) @\S*> \(size=(\d+),offset="
                         r"\d+\): (\S+)", alloc):
        name = m.group(1)
        r = ranges.get(name if "{" in name else name + "{}")
        copy = (name.split("{")[0] in converts and r is not None
                and any(r[0] <= w <= r[1] for w in loops))
        vals.append({"name": name, "bytes": int(m.group(2)),
                     "shape": m.group(3), "range": r, "cpu_copy": copy})

    def peak(skip_copies):
        end = max((v["range"][1] for v in vals if v["range"]), default=0)
        delta = [0] * (end + 2)
        for v in vals:
            if v["range"] and not (skip_copies and v["cpu_copy"]):
                delta[v["range"][0]] += v["bytes"]
                delta[v["range"][1] + 1] -= v["bytes"]
        best = cur = 0
        for d in delta:
            cur += d
            best = max(best, cur)
        return best

    return {"temp": int(re.search(r"size (\d+)", alloc).group(1)),
            "values": vals,
            "cpu_copies": sum(v["bytes"] for v in vals if v["cpu_copy"]),
            "live_peak": peak(False), "live_peak_less_cpu_copies": peak(True)}


def compile_cell(arch, shape, mesh_kind, dump):
    """Compile one cell (full width: ``shape`` names SHAPES and the mesh is
    the production 16x16 or 2x16x16 one; smoke: ``shape`` is a
    ShapeConfig and ``mesh_kind`` a (dims, axes) pair on 8 devices) with
    an XLA dump into ``dump``; returns its ``compiled_metrics`` memory
    and :func:`temp_buffers`' account."""
    smoke = not isinstance(shape, str)
    n = 8 if smoke else 512
    os.environ["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count={n}"
                               f" --xla_dump_to={dump} --xla_dump_hlo_as_text")
    import jax
    jax.devices()              # the flags above, before the dry run's own
    from repro.configs import SHAPES, get_config, smoke_config
    from repro.launch import dryrun
    from repro.launch.hlo_metrics import compiled_metrics
    from repro.launch.mesh import make_mesh, make_production_mesh
    if smoke:
        cfg = dryrun.tune_config(smoke_config(arch), shape.kind)
        mesh = make_mesh(*mesh_kind)
    else:
        shape = SHAPES[shape]
        cfg = dryrun.tune_config(get_config(arch), dryrun.cell_mode(shape))
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    mode = dryrun.cell_mode(shape)
    m = compiled_metrics(dryrun.lower_cell(cfg, shape, mesh, mode),
                         mesh.size)
    return m["memory"], temp_buffers(dump)


def _record(mem, bufs):
    top = sorted(bufs["values"], key=lambda v: -v["bytes"])
    return {"argument_bytes": mem["argument_bytes"],
            "temp_bytes": mem["temp_bytes"],
            "live_peak": bufs["live_peak"],
            "cpu_copies_bytes": bufs["cpu_copies"],
            "live_peak_less_cpu_copies": bufs["live_peak_less_cpu_copies"],
            "largest": [f"{v['shape']} {v['name']} {v['bytes']}"
                        + (" cpu_copy" if v["cpu_copy"] else "")
                        for v in top[:8]]}


def main(argv):
    if argv[0] == "--pins":
        path = argv[1]
        with open(path) as f:
            pins = json.load(f)
        ref = {}
        for arch, shape, mesh in PIN_CELLS:
            with tempfile.TemporaryDirectory() as d:
                # one process a cell: XLA reads its flags once
                out = os.path.join(d, "cell.json")
                cmd = (f"{sys.executable} {os.path.abspath(__file__)} "
                       f"{arch} {shape} {mesh} > {out}")
                if os.system(cmd) != 0:
                    raise RuntimeError(cmd)
                with open(out) as f:
                    ref[f"{mesh}/{arch}/{shape}"] = json.load(f)
        pins["reference"] = {
            "command": "python tests/_dryrun_reference.py --pins " + path,
            "jax": __import__("jax").__version__, "cells": ref}
        with open(path, "w") as f:
            json.dump(pins, f, indent=1)
            f.write("\n")
        return
    arch, shape, mesh = argv
    with tempfile.TemporaryDirectory() as d:
        mem, bufs = compile_cell(arch, shape, mesh, d)
    print(json.dumps(_record(mem, bufs)))


if __name__ == "__main__":
    main(sys.argv[1:])
