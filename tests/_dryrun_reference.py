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
those copies. ``live_peak_less_f32_converts`` also leaves out every f32
value a convert makes (inside the loop XLA's CPU backend slices each
layer's weights out of the f32 copy and converts them again for its
dot, a copy no eager step makes), and with them the f32 values its
program computes by a convert fusion. ``live_peak_less_dot_copies``
leaves out, besides those copies, only the f32 copies that a dot reads
of bf16 values (:func:`_dot_copies`), wherever the step makes them.

Usage:
    python tests/_dryrun_reference.py ARCH SHAPE single|multi   # one cell
    python tests/_dryrun_reference.py --pins tests/torch_dryrun_pins.json
        # the reference's values for the pins' full-width cells
    python tests/_dryrun_reference.py --grid tests/torch_dryrun_grid.json \
        [--jobs N]    # the reference's values for every run of the grid
"""
import glob
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

# the full-width cells whose reference values the pins keep
PIN_CELLS = (("qwen3-1.7b", "train_4k", "single"),
             ("deepseek-v2-236b", "decode_32k", "multi"),
             ("llama-3.2-vision-90b", "decode_32k", "multi"),
             ("rwkv6-7b", "train_4k", "single"),
             ("whisper-small", "train_4k", "single"),
             ("zamba2-1.2b", "train_4k", "single"))


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
    dot_copies = _dot_copies(hlo)
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
                     "shape": m.group(3), "range": r, "cpu_copy": copy,
                     "dot_copy": name.split("{")[0] in dot_copies})

    def peak(skip):
        end = max((v["range"][1] for v in vals if v["range"]), default=0)
        delta = [0] * (end + 2)
        for v in vals:
            if v["range"] and not skip(v):
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
            "live_peak": peak(lambda v: False),
            "live_peak_less_cpu_copies": peak(lambda v: v["cpu_copy"]),
            "live_peak_less_f32_converts": peak(
                lambda v: v["cpu_copy"] or (v["shape"].startswith("f32[")
                                            and "convert" in v["name"])),
            "live_peak_less_dot_copies": peak(
                lambda v: v["cpu_copy"] or v["dot_copy"])}


# floating-point ops that only move or convert values
_MOVES = {"parameter", "convert", "bitcast", "copy", "transpose", "reshape",
          "slice", "dynamic-slice", "concatenate", "broadcast"}


def _dot_copies(hlo: str) -> set:
    """The f32 values of an optimized HLO module that only widen bf16
    data for a dot: a ``convert`` of a bf16 value, or a fusion whose
    floating-point ops (scalars aside) only move or convert values, one of
    them bf16, which a dot or convolution reads as an operand. XLA's CPU
    backend gives each bf16 dot operand such an f32 copy, inside the
    layer loop as well as before it."""
    bodies = {m.group(1): m.group(2) for m in re.finditer(
        r"^(?:ENTRY )?%(\S+) [^\n]*\{\n(.*?)\n\}", hlo, re.M | re.S)}
    dtypes = dict(re.findall(r"%([\w.\-]+) = (\w+)\[", hlo))
    read = set()
    for m in re.finditer(r"= \S+ (?:dot|convolution)\(([^)]*)\)", hlo):
        read.update(re.findall(r"%([\w.\-]+)", m.group(1)))

    def widens(body):
        ops = re.findall(r"= (\w+)\[([^\]]*)\]\S* ([\w\-]+)\(", body)
        floats = [(dt, op) for dt, dims, op in ops
                  if dt in ("f32", "bf16", "f16") and dims]
        return (all(op in _MOVES for _, op in floats)
                and any(dt == "bf16" for dt, _ in floats))

    out = set()
    for m in re.finditer(r"^\s+%([\w.\-]+) = f32\[[^\n]*? (fusion|convert)"
                         r"\(([^)]*)\)([^\n]*)$", hlo, re.M):
        name, op, args, rest = m.groups()
        if name not in read:
            continue
        if op == "convert":
            if dtypes.get(args.strip().lstrip("%")) == "bf16":
                out.add(name)
            continue
        calls = re.search(r"calls=%([\w.\-]+)", rest)
        if calls and widens(bodies.get(calls.group(1), "")):
            out.add(name)
    return out


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
            "live_peak_less_f32_converts": bufs["live_peak_less_f32_converts"],
            "largest": [f"{v['shape']} {v['name']} {v['bytes']}"
                        + (" cpu_copy" if v["cpu_copy"] else "")
                        for v in top[:8]]}


def _compile_run(run) -> tuple:
    """("<mesh>/<arch>/<shape>", :func:`_record` of one run compiled in a
    process of its own (XLA reads its flags once), or ``{"error": ...}``)."""
    arch, shape, mesh = run
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), arch, shape, mesh],
        capture_output=True, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    key = f"{mesh}/{arch}/{shape}"
    rec = (json.loads(proc.stdout.strip().splitlines()[-1])
           if proc.returncode == 0 else {"error": proc.stderr[-400:]})
    print(f"{key}: {'error' if 'error' in rec else 'ok'}", file=sys.stderr,
          flush=True)
    return key, rec


def compile_all(runs, jobs=1) -> dict:
    """:func:`_record` of each (arch, shape, mesh) of ``runs``, ``jobs``
    compiled at once, by "<mesh>/<arch>/<shape>"; a run that fails to
    compile is ``{"error": ...}``."""
    with ThreadPoolExecutor(jobs) as ex:
        return dict(sorted(ex.map(_compile_run, runs)))


def main(argv):
    if argv[0] in ("--pins", "--grid"):
        path = argv[1]
        jobs = int(argv[argv.index("--jobs") + 1]) if "--jobs" in argv else 1
        with open(path) as f:
            tree = json.load(f)
        runs = (PIN_CELLS if argv[0] == "--pins" else
                [tuple(k.split("/")[1:]) + (k.split("/")[0],)
                 for k in tree["cells"]])
        t0 = time.time()
        ref = compile_all(runs, jobs)
        tree["reference"] = {
            "command": "python tests/_dryrun_reference.py " + " ".join(argv),
            "jax": __import__("jax").__version__,
            "wall_s": round(time.time() - t0, 1), "cells": ref}
        with open(path, "w") as f:
            json.dump(tree, f, indent=1)
            f.write("\n")
        return
    arch, shape, mesh = argv
    with tempfile.TemporaryDirectory() as d:
        mem, bufs = compile_cell(arch, shape, mesh, d)
    print(json.dumps(_record(mem, bufs)))


if __name__ == "__main__":
    main(sys.argv[1:])
