"""The port's example companions (``examples/*_torch.py``) and its training
launcher (``python -m repro_torch.launch.train``), on the CPU (``--device
cpu``), beside the reference's scripts at the same settings, all in
subprocesses side by side.

What depends on neither the weights nor the wall clock must equal the
reference's output: ``serve_multitenant``'s sim table, plan line and SLO
timeline (``--trace``), and the counts of its real-execution part (the
metrics leaves ``test_torch_launch._fixed`` keeps, the controller's
transitions, the pool's peak slots and swap counts); ``swap_serving``'s
model and PCIe scheduler tables and completion counts; the quickstart's
probe line, plan and coloring violations; the step numbers the trainers
print. Losses, latencies and the MLP's accuracy are the port's own (the
quickstart asserts that the loss falls, as the reference's does).
"""
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

from test_torch_launch import _fixed, _keys

ROOT = Path(__file__).resolve().parents[1]
EX = ROOT / "examples"
CPU = ["--device", "cpu"]
LAUNCH = ["--arch", "qwen3-1.7b", "--smoke", "--steps", "6", "--seq", "16",
          "--batch", "2"]
JOBS = {
    ("ref", "serve_multitenant"): [str(EX / "serve_multitenant.py"),
                                   "--trace"],
    ("port", "serve_multitenant"): [str(EX / "serve_multitenant_torch.py"),
                                    "--trace"] + CPU,
    ("ref", "swap_serving"): [str(EX / "swap_serving.py")],
    ("port", "swap_serving"): [str(EX / "swap_serving_torch.py")] + CPU,
    ("ref", "quickstart"): [str(EX / "quickstart.py")],
    ("port", "quickstart"): [str(EX / "quickstart_torch.py")] + CPU,
    ("ref", "train_small_lm"): [str(EX / "train_small_lm.py"), "--steps",
                                "40"],
    ("port", "train_small_lm"): [str(EX / "train_small_lm_torch.py"),
                                 "--steps", "40"] + CPU,
    ("ref", "launch"): ["-m", "repro.launch.train"] + LAUNCH,
    ("port", "launch"): ["-m", "repro_torch.launch.train"] + LAUNCH + CPU,
    ("port", "mesh"): ["-m", "repro_torch.launch.train"] + LAUNCH
    + ["--mesh", "2,2", "--devices", "4"] + CPU,
    ("port", "devices"): ["-m", "repro_torch.launch.train"] + LAUNCH
    + ["--devices", "4"] + CPU,
}


def _run(args):
    # two threads a process: the twelve share the host's cores (and the
    # suite's other workers) instead of each spreading over all of them
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="2", MKL_NUM_THREADS="2",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=2")
    proc = subprocess.run([sys.executable] + args, cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    return proc.returncode, proc.stdout, proc.stderr


@pytest.fixture(scope="module")
def runs():
    with ThreadPoolExecutor(max_workers=4) as pool:
        futs = {k: pool.submit(_run, a) for k, a in JOBS.items()}
        return {k: f.result() for k, f in futs.items()}


def _out(runs, side, name):
    rc, stdout, err = runs[(side, name)]
    assert rc == 0, err
    return stdout


def _jsons(text):
    """Every indented JSON object printed (top level), in order."""
    dec, out, i = json.JSONDecoder(), [], 0
    while True:
        i = text.find("{\n", i)
        if i < 0:
            return out
        obj, end = dec.raw_decode(text[i:])
        out.append(obj)
        i += end


def test_serve_multitenant_equals_reference(runs):
    ref = _out(runs, "ref", "serve_multitenant")
    port = _out(runs, "port", "serve_multitenant")
    # the plan, the sim table and its traced row's SLO timeline
    head = lambda t: t[:t.index("\nreal-")]
    assert "sgdrc+coloring+online" in head(port)
    assert "violation attribution" in head(port)
    assert head(port) == head(ref)
    assert "real-torch reduced-scale" in port
    got, want = _jsons(port), _jsons(ref)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert _keys(g) == _keys(w)
        assert _fixed(g) == _fixed(w)
    lines = lambda t, pre: [ln for ln in t.splitlines()
                            if ln.startswith(pre)]
    for pre in ("online transitions:", "peak concurrent slots:"):
        assert lines(port, pre) == lines(ref, pre) != []


def test_swap_serving_equals_reference(runs):
    ref = _out(runs, "ref", "swap_serving")
    port = _out(runs, "port", "swap_serving")
    cut = "\nswapped-in models serving"
    assert port[:port.index(cut)] == ref[:ref.index(cut)]
    assert "cfs nice=10K" in port
    done = lambda t: re.findall(r"(LS|BE): (\d+) done", t)
    assert done(port) == done(ref) == [("LS", "3"), ("BE", "3")]


def test_quickstart_companion(runs):
    ref = _out(runs, "ref", "quickstart")
    port = _out(runs, "port", "quickstart")
    assert port.rstrip().endswith("quickstart OK")
    probe = lambda t: re.search(r"\[reveng\] found .*probe acc [0-9.]+",
                                t).group(0)
    assert probe(port) == probe(ref)
    plan = lambda t: re.search(r"plan SM_BE=\S+ Ch_BE=\S+", t).group(0)
    assert plan(port) == plan(ref)
    viol = lambda t: re.search(r"coloring violations: \d+", t).group(0)
    assert viol(port) == viol(ref) == "coloring violations: 0"
    acc = float(re.search(r"MLP test acc ([0-9.]+)", port).group(1))
    assert acc > 0.95


def test_train_small_lm_companion(runs):
    ref = _out(runs, "ref", "train_small_lm")
    port = _out(runs, "port", "train_small_lm")
    fixed = lambda t: [re.sub(r"loss [0-9.]+", "loss L", ln)
                       for ln in t.splitlines()]
    assert fixed(port) == fixed(ref)
    assert "[phase 2] auto-resumed at step 20" in port


def test_train_launcher_prints_reference_lines(runs):
    ref = _out(runs, "ref", "launch")
    port = _out(runs, "port", "launch")
    fixed = lambda t: [re.sub(r"loss [0-9.]+|\d+ ms", "N", ln)
                       for ln in t.splitlines()]
    assert [ln.split("stragglers")[0] for ln in fixed(port)] == \
        [ln.split("stragglers")[0] for ln in fixed(ref)]
    assert len(fixed(port)) == 7 and "stragglers flagged:" in port


@pytest.mark.parametrize("flag", ["mesh", "devices"])
def test_train_launcher_mesh_flags_exit(runs, flag):
    """``--mesh 2,2 --devices 4`` trains sharded on 4 gloo ranks and
    ``--devices 4`` unsharded on each: rank 0 prints the reference's 7
    lines (step numbers equal; losses and times the port's)."""
    ref = _out(runs, "ref", "launch")
    port = _out(runs, "port", flag)
    fixed = lambda t: [re.sub(r"loss [0-9.]+|\d+ ms", "N", ln)
                       for ln in t.splitlines()]
    assert [ln.split("stragglers")[0] for ln in fixed(port)] == \
        [ln.split("stragglers")[0] for ln in fixed(ref)]
    assert len(fixed(port)) == 7 and "stragglers flagged:" in port
    # the sharded and the replicated runs print the unsharded losses (to
    # the printed 4 decimals, one rounding step apart at most)
    losses = lambda t: [float(x) for x in re.findall(r"loss ([0-9.]+)", t)]
    got, want = losses(port), losses(_out(runs, "port", "launch"))
    assert len(got) == len(want) == 7
    assert max(abs(a - b) for a, b in zip(got, want)) <= 1.5e-4
