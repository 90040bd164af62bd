"""The port's dry run (``repro_torch.launch.dryrun``) on small fake meshes:
the twin of ``tests/test_dryrun_small.py``. The six smoke cells (qwen3
train, deepseek-v2 decode, zamba2 prefill on (data=2, model=4) and
(pod=2, data=2, model=2)) are traced in one subprocess, each on a fake
process group of 8 ranks: FLOPs above 0, the multi-pod cells
communicate, and their per-device argument bytes equal those of the
reference's compiled cells (a second subprocess, 8 fake XLA devices).
The same subprocess traces two cells at 0 to 3 periods: the
port has no scan, so FLOPs are exactly linear in the periods (the
reference needs probes and a scaling rule for that). At full width,
qwen3-1.7b ``decode_32k`` placed on the 16x16 mesh has the per-device
argument bytes that the reference's specs give (placing meta tensors, no
step traced)."""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

SCRIPT = r"""
import json
from repro_torch.configs import smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.dryrun import trace_cell, tune_config
from repro_torch.launch.mesh import fake_group, make_mesh

CELLS = [("qwen3-1.7b", ShapeConfig("t", 64, 8, "train")),
         ("deepseek-v2-236b", ShapeConfig("d", 64, 8, "decode")),
         ("zamba2-1.2b", ShapeConfig("p", 64, 8, "prefill"))]
out = {}
for mesh_name, dims, axes in [("single", (2, 4), ("data", "model")),
                              ("multi", (2, 2, 2), ("pod", "data", "model"))]:
    with fake_group(8):
        mesh = make_mesh(dims, axes)
        for arch, shape in CELLS:
            cfg = tune_config(smoke_config(arch), shape.kind)
            m = trace_cell(cfg, shape, mesh, shape.kind)
            out[f"{mesh_name}/{arch}/{shape.kind}"] = {
                "flops": m["flops"],
                "colls": sum(m["collectives"]["counts"].values()),
                "wire": m["collectives"]["total_wire_bytes"],
                "memory": m["memory"]}
        if mesh_name == "single":
            for arch, shape in (CELLS[0], CELLS[2]):
                base = smoke_config(arch)
                for n in (0, 1, 2, 3):
                    cfg = tune_config(base.with_layers(n * base.probe_period),
                                      shape.kind)
                    m = trace_cell(cfg, shape, mesh, shape.kind)
                    out[f"periods/{arch}/{n}"] = m["flops"]
print(json.dumps(out))
"""


# the reference's compiled twin of SCRIPT's six cells, on 8 fake XLA devices
REF_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
from repro.configs import smoke_config
from repro.configs.base import ShapeConfig
from repro.launch.dryrun import lower_cell, tune_config
from repro.launch.hlo_metrics import compiled_metrics
from repro.launch.mesh import make_mesh

out = {}
for mesh_name, dims, axes in [("single", (2, 4), ("data", "model")),
                              ("multi", (2, 2, 2), ("pod", "data", "model"))]:
    mesh = make_mesh(dims, axes)
    for arch, shape in [("qwen3-1.7b", ShapeConfig("t", 64, 8, "train")),
                        ("deepseek-v2-236b", ShapeConfig("d", 64, 8, "decode")),
                        ("zamba2-1.2b", ShapeConfig("p", 64, 8, "prefill"))]:
        cfg = tune_config(smoke_config(arch), shape.kind)
        m = compiled_metrics(lower_cell(cfg, shape, mesh, shape.kind), 8)
        out[f"{mesh_name}/{arch}/{shape.kind}"] = m["memory"]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def traced():
    """The port's SCRIPT and the reference's REF_SCRIPT, side by side in
    two subprocesses; returns the port's dict with the reference's
    memory records under "ref"."""
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, OMP_NUM_THREADS="2", JAX_PLATFORMS="cpu",
               PYTHONPATH=src)
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for code in (SCRIPT, REF_SCRIPT)]
    outs = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=900)
        assert p.returncode == 0, stderr[-3000:]
        outs.append(json.loads(stdout.strip().splitlines()[-1]))
    return dict(outs[0], ref=outs[1])


def test_small_mesh_dryrun_all_modes(traced):
    cells = {k: v for k, v in traced.items()
             if not k.startswith(("periods", "ref"))}
    assert len(cells) == 6
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
    """Each of the six cells' per-device argument bytes equal those of
    the reference's compiled executable (XLA's memory analysis) on the
    same fake mesh: the same specs place the same shards."""
    ref = traced["ref"]
    assert len(ref) == 6
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
