"""The port's dry run (``repro_torch.launch.dryrun``) on small fake meshes:
the twin of ``tests/test_dryrun_small.py``. The smoke cells
(``SMOKE_CELLS``: qwen3 train, deepseek-v2 decode, zamba2 prefill,
whisper and llama-3.2-vision train and decode, rwkv6 and zamba2 train, on
(data=2, model=4) and (pod=2, data=2, model=2)) are traced in one
subprocess a mesh, each on a fake process group of 8 ranks: FLOPs above
0, the multi-pod cells communicate, and their per-device argument bytes
equal those of the reference's compiled cells (a subprocess a mesh, 8
fake XLA devices, whose temp buffers are read from XLA's dump via
``tests/_dryrun_reference.py``). Each cell's temp is held to the
reference's, its collectives, FLOPs and temp to
``tests/torch_dryrun_pins.json``, and the qwen3 cells' logits are never
gathered whole. The pins' full-width cells give the reference's
fits-in-80-GB verdicts less XLA's CPU copies, and so does every run of
the reference's whole grid recorded in ``tests/torch_dryrun_grid.json``,
or the run is named in ``ROADMAP.md``'s queue 3.
The single-mesh subprocess also traces two cells at 0 to 3 periods: the
port has no scan, so FLOPs are exactly linear in the periods (the
reference needs probes and a scaling rule for that). At full width,
qwen3-1.7b ``decode_32k`` placed on the 16x16 mesh has the per-device
argument bytes that the reference's specs give (placing meta tensors, no
step traced)."""
import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro_torch.launch.dryrun import (PIN_CELLS, SMOKE_MESHES, fits,
                                       grid_runs)

SCRIPT = r"""
import json, os
from repro_torch.configs import smoke_config
from repro_torch.launch.dryrun import (SMOKE_CELLS, SMOKE_MESHES, summary,
                                       trace_cell, tune_config)
from repro_torch.launch.mesh import fake_group, make_mesh

mesh_name = os.environ["SMOKE_MESH"]
part = [tuple(cell) for cell in json.loads(os.environ["SMOKE_PART"])]
out = {}
with fake_group(8):
    mesh = make_mesh(*SMOKE_MESHES[mesh_name])
    for arch, shape in SMOKE_CELLS:
        if (arch, shape.kind) not in part:
            continue
        m = trace_cell(tune_config(smoke_config(arch), shape.kind), shape,
                       mesh, shape.kind)
        out[f"{mesh_name}/{arch}/{shape.kind}"] = dict(
            summary(m), colls=sum(m["collectives"]["counts"].values()),
            wire=m["collectives"]["total_wire_bytes"], memory=m["memory"],
            shapes=m["collectives"]["shapes"])
    if os.environ["SMOKE_PERIODS"] == "1":
        for arch, shape in (SMOKE_CELLS[0], SMOKE_CELLS[2]):
            base = smoke_config(arch)
            for n in (0, 1, 2, 3):
                cfg = tune_config(base.with_layers(n * base.probe_period),
                                  shape.kind)
                m = trace_cell(cfg, shape, mesh, shape.kind)
                out[f"periods/{arch}/{n}"] = m["flops"]
print(json.dumps(out))
"""


# the reference's compiled twin of SCRIPT's cells on one mesh, on 8 fake
# XLA devices, each step's temp buffers read from XLA's dump
# (``tests/_dryrun_reference.py``)
REF_SCRIPT = r"""
import os, shutil, sys, tempfile
dump = tempfile.mkdtemp()
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           f"--xla_dump_to={dump} --xla_dump_hlo_as_text")
import jax
jax.devices()            # these flags, before repro.launch.dryrun sets its own
import json
from repro.configs import smoke_config
from repro.configs.base import ShapeConfig
from repro.launch.dryrun import lower_cell, tune_config
from repro.launch.hlo_metrics import compiled_metrics
from repro.launch.mesh import make_mesh
sys.path.insert(0, os.environ["TESTS_DIR"])
from _dryrun_reference import temp_buffers

mesh_name, dims, axes, cells = json.loads(os.environ["SMOKE_REF"])
mesh = make_mesh(tuple(dims), tuple(axes))
out = {}
for arch, kind in cells:
    shape = ShapeConfig(kind[0], 64, 8, kind)
    cfg = tune_config(smoke_config(arch), shape.kind)
    before = set(os.listdir(dump))
    m = compiled_metrics(lower_cell(cfg, shape, mesh, shape.kind), 8)
    cell = os.path.join(dump, "cell")
    os.makedirs(cell)
    for f in set(os.listdir(dump)) - before - {"cell"}:
        shutil.move(os.path.join(dump, f), cell)
    b = temp_buffers(cell)
    shutil.rmtree(cell)
    out[f"{mesh_name}/{arch}/{shape.kind}"] = dict(
        m["memory"], live_peak=b["live_peak"], cpu_copies=b["cpu_copies"],
        live_peak_less_cpu_copies=b["live_peak_less_cpu_copies"],
        live_peak_less_f32_converts=b["live_peak_less_f32_converts"],
        live_peak_less_dot_copies=b["live_peak_less_dot_copies"])
shutil.rmtree(dump)
print(json.dumps(out))
"""

HERE = os.path.dirname(os.path.abspath(__file__))
PINS = os.path.join(HERE, "torch_dryrun_pins.json")
GRID = os.path.join(HERE, "torch_dryrun_grid.json")
# the smoke cells on each mesh (the port's ``SMOKE_CELLS`` must trace
# these); the first three were pinned before the cross-attention and rwkv6
# placements came, the rest with them and zamba2's head split
_FIRST = ["qwen3-1.7b/train", "deepseek-v2-236b/decode",
          "zamba2-1.2b/prefill"]
_LATER = ["whisper-small/train", "whisper-small/decode",
          "llama-3.2-vision-90b/train", "llama-3.2-vision-90b/decode",
          "rwkv6-7b/train", "zamba2-1.2b/train"]
SMOKE = [f"{mesh}/{cell}" for mesh in ("single", "multi")
         for cell in _FIRST + _LATER]
FIRST = {f"{mesh}/{cell}" for mesh in ("single", "multi") for cell in _FIRST}


@pytest.fixture(scope="module")
def traced():
    """The port's SCRIPT and the reference's REF_SCRIPT on each smoke
    mesh, each side's cells in two parts, eight subprocesses side by side:
    zamba2's train cell, the last, alone (XLA's compile of it takes about
    as long as the other cells' together), the periods' traces with it;
    returns the port's dict with the reference's memory records under
    "ref"."""
    src = os.path.join(HERE, "..", "src")
    env = dict(os.environ, OMP_NUM_THREADS="2", JAX_PLATFORMS="cpu",
               PYTHONPATH=src, TESTS_DIR=HERE)
    cells = [cell.split("/") for cell in _FIRST + _LATER]
    envs = []
    for name, (dims, axes) in SMOKE_MESHES.items():
        for i, part in enumerate((cells[:-1], cells[-1:])):
            envs += [(SCRIPT, dict(env, SMOKE_MESH=name,
                                   SMOKE_PART=json.dumps(part),
                                   SMOKE_PERIODS=str(int(
                                       name == "single" and i == 1)))),
                     (REF_SCRIPT, dict(env, SMOKE_REF=json.dumps(
                         [name, dims, axes, part])))]
    procs = [subprocess.Popen([sys.executable, "-c", code], env=e,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for code, e in envs]
    port, ref = {}, {}
    for (code, _), p in zip(envs, procs):
        stdout, stderr = p.communicate(timeout=900)
        assert p.returncode == 0, stderr[-3000:]
        (port if code is SCRIPT else ref).update(
            json.loads(stdout.strip().splitlines()[-1]))
    return dict(port, ref=ref)


def test_small_mesh_dryrun_all_modes(traced):
    cells = {k: v for k, v in traced.items()
             if not k.startswith(("periods", "ref"))}
    assert sorted(cells) == sorted(SMOKE)
    for k, v in cells.items():
        assert v["flops"] > 0, k
        mem = v["memory"]
        assert mem["argument_bytes"] > 0 and mem["temp_bytes"] > 0, k
        assert mem["code_bytes"] == 0
    assert any(v["colls"] > 0 for k, v in cells.items()
               if k.startswith("multi"))
    assert all(v["wire"] > 0 for k, v in cells.items()
               if k.startswith("multi"))


@pytest.mark.parametrize("arch,first", [("qwen3-1.7b", 0),
                                        ("zamba2-1.2b", 1)])
def test_traced_flops_linear_in_periods(traced, arch, first):
    """Every period is traced, so each adds the same FLOPs: qwen3 from 0
    periods on. zamba2 from 1 on: its first period follows the two dense
    mamba prefix layers, whose output reaches it in another placement than
    a period's shared block hands on (DTensor places each op by its
    inputs), so the first period's per-device FLOPs differ from the rest,
    which are all equal."""
    f = [traced[f"periods/{arch}/{n}"] for n in (0, 1, 2, 3)]
    assert f[1] > f[0] > 0
    a, b, c = f[first:first + 3]
    assert c - b == b - a


def test_argument_bytes_equal_reference_compiled(traced):
    """Each smoke cell's per-device argument bytes equal those of the
    reference's compiled executable (XLA's memory analysis) on the same
    fake mesh: the same specs place the same shards, and an argument the
    step never reads (whisper's encoder weights in a decode step given
    the encoder output) counts on neither side."""
    ref = traced["ref"]
    assert sorted(ref) == sorted(SMOKE)
    for k, mem in ref.items():
        assert traced[k]["memory"]["argument_bytes"] == \
            mem["argument_bytes"], k


def test_full_width_decode_argument_bytes_match_reference_specs():
    """qwen3-1.7b decode_32k on 16x16: the port's per-device argument
    bytes (params, token, cache, the int32 position) equal the local shard
    bytes of the reference's specs (each dim over the product of the mesh
    axes its spec names)."""
    from repro.configs import get_config as jget
    from repro.dist import sharding as jsh
    from repro.launch import dryrun as jdry
    from repro.launch import specs as jspecs
    from repro.models import transformer as jtf
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.dryrun import place_cell, tune_config
    from repro_torch.launch.hlo_metrics import argument_bytes
    from repro_torch.launch.mesh import fake_group, make_production_mesh

    shape = SHAPES["decode_32k"]
    dims = {"data": 16, "model": 16}
    jmesh = AbstractMesh((16, 16), ("data", "model"))
    jcfg = jdry.tune_config(jget("qwen3-1.7b"), "decode")
    params = jax.eval_shape(lambda k: jtf.init_params(k, jcfg),
                            jax.random.key(0))
    pspecs = jsh.param_pspecs(params, jmesh)
    (token, cache, extras), (tsh, csh, esh) = jspecs.input_specs(
        jcfg, shape, jmesh, "decode")

    def local(tree, specs):
        total = 0
        for a, s in zip(jax.tree.leaves(tree),
                        jax.tree.leaves(specs,
                                        is_leaf=lambda x: hasattr(x, "spec"))):
            n = a.dtype.itemsize
            spec = tuple(s.spec) + (None,) * (a.ndim - len(s.spec))
            for d, ax in zip(a.shape, spec):
                axes = () if ax is None else (ax,) if isinstance(ax, str) \
                    else ax
                n *= d // int(np.prod([dims[x] for x in axes]))
            total += n
        return total

    want = (local(params, pspecs) + local(token, tsh) + local(cache, csh)
            + local(extras, esh) + 4)
    with fake_group(256):
        mesh = make_production_mesh()
        cfg = tune_config(get_config("qwen3-1.7b"), "decode")
        _, args = place_cell(cfg, shape, mesh, "decode")
        got = argument_bytes(args)
    assert got == want
    assert got < 80e9


# port temp over the reference's, by cell kind. Train: over its compiled
# temp. Decode and prefill: over the largest sum of temp buffers live at
# once in XLA's program less the f32 copies XLA's CPU backend makes of
# the step's bf16 inputs before the layer loop
# (``tests/_dryrun_reference.py``; no eager step makes them), in a band
# tied to the buffers PERF.md's dry-run findings name: decode, XLA
# gathers each layer's experts whole in f32 (its CPU copy, twice the
# port's bf16 gather: 1.0 of deepseek-v2's 1.09 MiB here, 18.75 of 18.83
# GiB at full width); prefill, zamba2's mamba layers split their heads
# over "model" on both sides, so the per-rank scan buffers scale as
# 1/model (XLA's 1.77 MiB on model=4, 3.27 on model=2; the port's 1.35
# and 1.56, 0.76 and 0.48 of XLA's, whose peak on model=2 also holds
# 0.94 MiB of f32 converts of a layer's bf16 in_proj for its dot; 2.59
# MiB on both meshes before the split, when the port ran every head on
# every rank), its band about 0.8x the lower and 1.25x the higher ratio
BANDS = {"train": (0.8, 1.25), "decode": (0.4, 1.25),
         "prefill": (0.38, 0.95)}


# the cells that came with the cross-attention, rwkv6 and mamba2
# placements, held to XLA's own live ranges: "<arch>/<kind>" -> the reference's value
# that the port's temp is divided by, and the band (about 0.8x the lowest
# and 1.25x the highest ratio measured on the two smoke meshes). Train:
# the live peak (the allocation less its fragmentation), 0.80-1.07
# measured. whisper's and the VLM's train run the attention core, whose
# P.V the port computes from P's bf16 rounding and v as they are, saving
# P once in f32 and v in bf16, as an accelerator's compile does; XLA's
# CPU backend has no bf16 dot and gives both operands an f32 copy. So
# those two are held to the live peak less the f32 copies that XLA's
# dots read of bf16 values (0.89 and 0.94 on (2, 2, 2), 1.07 and 1.13
# on (2, 4); against the whole live peak 0.73-0.87), in the same band.
# whisper's decode: the live peak less the hoisted copies, as
# deepseek-v2's (0.34 on (2, 2, 2), 0.54 on (2, 4)). The VLM's decode:
# XLA's CPU backend also slices each layer's bf16 weights out of the f32
# copy of the stack and converts them again for its dots (696 of the 772
# KB live less the hoisted copies on (2, 4)), a copy no eager step makes,
# so the live peak less every f32 value a convert makes (0.68 on (2, 2,
# 2), 0.76 on (2, 4)). zamba2's train, its mamba layers' heads split
# over "model" on both sides: the live peak, 0.64 on (2, 2, 2) and 0.75
# on (2, 4); XLA's peak holds its scan's f32 broadcasts of B and C to
# each head ([chunks, B, L, H, N], 7.9 of its 32.8 MB on (2, 2, 2)),
# which the port's chunk step never builds whole. Before the split, when
# the port ran every head on every rank, 0.98 and 1.71
LIVE_BANDS = {
    "whisper-small/train": ("live_peak_less_dot_copies", 0.75, 1.25),
    "llama-3.2-vision-90b/train": ("live_peak_less_dot_copies", 0.75, 1.25),
    "rwkv6-7b/train": ("live_peak", 0.75, 1.25),
    "zamba2-1.2b/train": ("live_peak", 0.5, 0.94),
    "whisper-small/decode": ("live_peak_less_cpu_copies", 0.27, 0.68),
    "llama-3.2-vision-90b/decode": ("live_peak_less_f32_converts", 0.55,
                                    0.95)}


@pytest.mark.parametrize("cell", SMOKE)
def test_temp_held_to_reference(traced, cell):
    got = traced[cell]["memory"]["temp_bytes"]
    ref = traced["ref"][cell]
    kind = cell.rsplit("/", 1)[1]
    assert ref["live_peak"] <= ref["temp_bytes"]
    if cell not in FIRST:
        key, lo, hi = LIVE_BANDS[cell.split("/", 1)[1]]
        assert lo <= got / ref[key] <= hi, (cell, got, ref)
        return
    want = ref["temp_bytes"] if kind == "train" else \
        ref["live_peak_less_cpu_copies"]
    lo, hi = BANDS[kind]
    assert lo <= got / want <= hi, (cell, got, ref)


# an optimized module in XLA's text form: the f32 values a dot reads that
# only widen bf16 data (%c a convert, %w a convert fusion with a
# transpose, %r P's bf16 rounding widened again) against one that also
# computes (%s), one no dot reads (%u) and an f32 parameter (%p1)
_HLO = """HloModule m

%fused_widen (param_0: bf16[4,8]) -> f32[8,4] {
  %param_0 = bf16[4,8]{1,0} parameter(0)
  %convert.1 = f32[4,8]{1,0} convert(%param_0)
  ROOT %transpose.1 = f32[8,4]{0,1} transpose(%convert.1), dimensions={1,0}
}

%fused_round (param_0: f32[8,4]) -> f32[8,4] {
  %param_0 = f32[8,4]{1,0} parameter(0)
  %convert.2 = bf16[8,4]{1,0} convert(%param_0)
  ROOT %convert.3 = f32[8,4]{1,0} convert(%convert.2)
}

%fused_scale (param_0: bf16[4,8], param_1: f32[8,4]) -> f32[8,4] {
  %param_0 = bf16[4,8]{1,0} parameter(0)
  %param_1 = f32[8,4]{1,0} parameter(1)
  %convert.4 = f32[4,8]{1,0} convert(%param_0)
  %transpose.2 = f32[8,4]{0,1} transpose(%convert.4), dimensions={1,0}
  ROOT %multiply.1 = f32[8,4]{1,0} multiply(%transpose.2, %param_1)
}

ENTRY %main (p0: bf16[4,8], p1: f32[8,4]) -> f32[4,4] {
  %p0 = bf16[4,8]{1,0} parameter(0)
  %p1 = f32[8,4]{1,0} parameter(1)
  %c = f32[4,8]{1,0} convert(%p0)
  %u = f32[4,8]{1,0} convert(%p0)
  %w = f32[8,4]{0,1} fusion(%p0), kind=kLoop, calls=%fused_widen
  %r = f32[8,4]{1,0} fusion(%p1), kind=kLoop, calls=%fused_round
  %s = f32[8,4]{1,0} fusion(%p0, %p1), kind=kLoop, calls=%fused_scale
  %dot.1 = f32[4,4]{1,0} dot(%c, %w), lhs_contracting_dims={1}
  %a = f32[4,8]{1,0} add(%u, %u)
  %dot.3 = f32[4,4]{1,0} dot(%c, %r), lhs_contracting_dims={1}
  ROOT %dot.4 = f32[4,4]{1,0} dot(%c, %s), lhs_contracting_dims={1}
}
"""


@pytest.mark.parametrize("name,copy", [("c", True), ("w", True),
                                       ("r", True), ("s", False),
                                       ("u", False), ("p1", False)])
def test_dot_copies_only_widen_bf16_for_a_dot(name, copy):
    """``live_peak_less_dot_copies`` leaves out exactly the f32 values
    that a dot reads and that only hold bf16 data widened
    (``tests/_dryrun_reference.py::_dot_copies``), not an f32 value that
    also computes, nor one read by no dot."""
    from _dryrun_reference import _dot_copies
    got = _dot_copies(_HLO)
    assert (name in got) == copy, got


@pytest.mark.parametrize("cell", SMOKE)
def test_smoke_cell_matches_pins(traced, cell):
    """The trace is a function of the tree: each smoke cell's collective
    counts by kind and argument bytes equal the pinned ones, its FLOPs
    and temp within 2% (``chip_smoke.py`` phase 16c holds the card's
    host, another torch, to the same file)."""
    with open(PINS) as f:
        pin = json.load(f)["cells"][cell]
    got = traced[cell]
    assert got["collectives"] == pin["collectives"], cell
    assert got["argument_bytes"] == pin["argument_bytes"], cell
    for k in ("flops", "temp_bytes"):
        assert abs(got[k] / pin[k] - 1) <= 0.02, (cell, k, got[k], pin[k])


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_logits_never_gathered_whole(traced, mesh):
    """In the qwen3 train cell no all-gather's result holds as many
    elements as one rank's rows of logits over the whole vocabulary
    (4 rows x 64 tokens x 512): the logits stay split on the vocabulary
    through the f32 cast, the logsumexp and the gold logit, forward and
    backward. Before the fix, torch 2.13's DTensor gathered them whole
    over "model" (at full width one f32 [256, 4096, 9496] all-gather)."""
    whole = 4 * 64 * 512
    for key in traced[f"{mesh}/qwen3-1.7b/train"]["shapes"]:
        if key.startswith("all-gather"):
            dims = re.search(r"\[([\d, ]*)\]", key).group(1).split(",")
            assert int(np.prod([int(d) for d in dims])) < whole, key


def test_full_width_pins_give_reference_verdicts():
    """The pinned full-width cells (``python -m repro_torch.launch.dryrun
    --pins``: traced in 15-250 s each, so not in this suite)
    against the reference's compiled values pinned beside them
    (``tests/_dryrun_reference.py --pins``): argument bytes equal, qwen3
    ``train_4k``'s temp within 0.8-1.25x of the reference's, and each
    cell's fits-in-80-GB verdict (argument + temp under 80e9 B) the
    reference's once XLA's CPU copies of the step's bf16 inputs are taken
    out. Taken as compiled, the reference's deepseek-v2
    ``decode_32k`` does not fit: 55.67 of its 75.02 GiB of temp are f32
    copies of the stacked bf16 expert weights and caches, made before the
    layer loop because the CPU has no bf16 dot. rwkv6-7b ``train_4k``
    fits on both sides (before the SSM chunk step lost its [B, L, L, H,
    K] decay and the rwkv layer its whole-weight placement, the port read
    361.79 GiB of temp there), and so does whisper-small ``train_4k``
    (before the row-blocked NLL and the encoder's attention weights kept
    once, the port read 117.91 GiB of temp there, where the reference's
    live peak is 73.65). zamba2-1.2b ``train_4k`` fits on neither side,
    its temp within 1.25x the reference's live peak (1.90x while its
    mamba2 layers ran every head on every rank; the reference's values
    for this cell, on both sides, are the grid's: ``from_grid``)."""
    with open(PINS) as f:
        pins = json.load(f)
    ref = pins["reference"]["cells"]
    for arch, shape, mesh in PIN_CELLS:
        cell = f"{mesh}/{arch}/{shape}"
        got, want = pins["cells"][cell], ref[cell]
        assert got["argument_bytes"] == want["argument_bytes"], cell
        assert fits(got["argument_bytes"], got["temp_bytes"]) == fits(
            want["argument_bytes"], want["live_peak_less_cpu_copies"]), cell
    q = pins["cells"]["single/qwen3-1.7b/train_4k"]
    qref = ref["single/qwen3-1.7b/train_4k"]
    assert 0.8 <= q["temp_bytes"] / qref["temp_bytes"] <= 1.25
    assert fits(q["argument_bytes"], q["temp_bytes"]) == \
        fits(qref["argument_bytes"], qref["temp_bytes"])
    d = ref["multi/deepseek-v2-236b/decode_32k"]
    assert not fits(d["argument_bytes"], d["temp_bytes"])
    r = pins["cells"]["single/rwkv6-7b/train_4k"]
    assert fits(r["argument_bytes"], r["temp_bytes"])
    w = pins["cells"]["single/whisper-small/train_4k"]
    assert fits(w["argument_bytes"], w["temp_bytes"])
    z = pins["cells"]["single/zamba2-1.2b/train_4k"]
    zref = ref["single/zamba2-1.2b/train_4k"]
    assert not fits(z["argument_bytes"], z["temp_bytes"])
    assert z["temp_bytes"] / zref["live_peak"] <= 1.25


def _queue3() -> str:
    """ROADMAP.md's queue 3 (faults of the port against the reference)."""
    with open(os.path.join(HERE, "..", "ROADMAP.md")) as f:
        text = f.read()
    start = text.index("### Queue 3")
    return text[start:text.index("\n## ", start)]


@pytest.fixture(scope="module")
def grid():
    with open(GRID) as f:
        return json.load(f)


def test_grid_holds_every_run(grid):
    """``tests/torch_dryrun_grid.json`` (``python -m
    repro_torch.launch.dryrun --grid`` beside ``tests/_dryrun_reference.py
    --grid``) records all 64 runs of the reference's applicable grid, 32
    cells on the single- and the multi-pod mesh, on both sides."""
    runs = {f"{m}/{a}/{s}" for a, s, m in grid_runs()}
    assert len(runs) == 64
    assert set(grid["cells"]) == runs
    assert set(grid["reference"]["cells"]) == runs


@pytest.mark.parametrize("run", sorted(f"{m}/{a}/{s}"
                                       for a, s, m in grid_runs()))
def test_grid_run_held_to_reference(grid, run):
    """Each run of the grid traced (``ok``), its argument bytes the
    reference's compiled ones, and its fits-in-80-GB verdict the
    reference's less XLA's CPU copies, or the run named in
    ``ROADMAP.md``'s queue 3 with the buffers behind the difference."""
    got, want = grid["cells"][run], grid["reference"]["cells"][run]
    assert got["ok"], (run, got.get("error"))
    assert "error" not in want, (run, want.get("error"))
    assert got["argument_bytes"] == want["argument_bytes"], run
    if fits(got["argument_bytes"], got["temp_bytes"]) != fits(
            want["argument_bytes"], want["live_peak_less_cpu_copies"]):
        assert f"`{run}`" in _queue3(), run
