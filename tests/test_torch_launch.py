"""The port's serving launcher, ``python -m repro_torch.launch.serve``, in
subprocesses on the CPU (``--torch-device cpu``).

Its ``--backend sim`` stdout equals the reference launcher's
(``python -m repro.launch.serve --backend sim``) byte for byte: with no
other flag, with ``--prefix-cache`` and with ``--grid-search``. On the torch
backend, each flag set the chip smoke drives (paged with the prefix cache
and the swap tier, dense chunked, the online controller over colored
pools, disaggregation over four modeled devices, a trace whose JSONL
passes the port's schema check, an LS deepseek-v2 + BE moonshot pair,
paged; the paged set also with one slot, where
the prefix cache hits, and over two pages, where a request
swaps out and back) and ``--chaos`` exits 0, completes every
request and prints the metrics keys the reference launcher prints for the
same flags. Every value that does not depend on the weights or on the
wall clock (counts, tokens, pages, bytes, prefix hits, swap and migration
counts, flows, quanta, the summary lines) equals the reference's exactly;
only wall-clock times are compared by key. ``--chaos`` anchors its fault
times to the wall clock, so it is compared by key alone. Tokens are not
compared: the reference's default weights are salted per process. The sim
backend runs without ``--torch-device``: it needs no card. The reference's flag sets run through its ``main()``,
in three processes; all processes run side by side."""
import contextlib
import io
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--requests", "2", "--max-new", "2"]
SIM_FLAGS = {"plain": [], "prefix": ["--prefix-cache"],
             "grid": ["--grid-search"]}
PAGED = ["--paged", "--use-flash", "--chunk-size", "8", "--prefix-cache",
         "--swap"]
TORCH_FLAGS = {
    "paged": PAGED,
    # one slot: the second request hits the first's donated prefix; two
    # slots over two pages: one swap-out and back
    "paged_hits": PAGED + ["--slots", "1", "--kv-pages", "4"],
    "paged_swap": PAGED + ["--slots", "2", "--kv-pages", "2", "--max-new",
                           "6"],
    "dense": ["--use-flash", "--chunk-size", "8"],
    "online": ["--online", "--coloring", "--paged", "--use-flash"],
    "disagg": ["--disagg", "--use-flash", "--devices", "4",
               "--prefill-devices", "2"],
    "trace": ["--trace", "TRACE", "--paged", "--use-flash"],
    "chaos": ["--chaos"],
    # the MLA + MoE LS tenant beside the GQA + MoE BE tenant
    "moe_mla": ["--ls", "deepseek-v2-236b", "--be", "moonshot-v1-16b-a3b",
                "--paged"],
}

# one process that runs the reference launcher's main() once per flag set
# (argv in sys.argv) and prints {name: stdout} as one JSON line
_REF_LOOP = """
import contextlib, io, json, sys
from repro.launch import serve
out = {}
for name, argv in json.loads(sys.argv[1]).items():
    buf = io.StringIO()
    sys.argv = ["serve"] + argv
    with contextlib.redirect_stdout(buf):
        serve.main()
    out[name] = buf.getvalue()
print(json.dumps(out))
"""


def _env():
    return dict(os.environ, JAX_PLATFORMS="cpu",
                PYTHONPATH=str(ROOT / "src"))


def _run(args):
    proc = subprocess.run([sys.executable] + args, cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=600)
    return proc.returncode, proc.stdout, proc.stderr


def _metrics(stdout: str) -> dict:
    """The metrics JSON the launcher prints (indented, after any plan
    line)."""
    i = stdout.index("{\n")
    return json.JSONDecoder().raw_decode(stdout[i:])[0]


def _keys(d, pre=""):
    out = set()
    if isinstance(d, dict):
        for k, v in d.items():
            out.add(f"{pre}/{k}")
            out |= _keys(v, f"{pre}/{k}")
    return out


#: metrics leaves read off the wall clock (the launcher's engines run on
#: it, except ``--disagg``'s virtual clock): compared by key only
_WALL_LEAVES = {"elapsed_s", "throughput_rps", "tokens_per_s"}
_WALL_STATS = {"mean", "p50", "p99", "window_p99"}


def _fixed(d, path=()):
    """The metrics leaves that depend on neither the weights nor the wall
    clock, by path."""
    out = {}
    if isinstance(d, dict):
        for k, v in d.items():
            out.update(_fixed(v, path + (k,)))
    elif not (path[-1].endswith("_ms") or path[-1] in _WALL_LEAVES
              or (len(path) > 1 and path[-2].endswith("_ms")
                  and path[-1] in _WALL_STATS)):
        out["/".join(path)] = d
    return out


def _summary(stdout: str, trace: str) -> list:
    """The launcher's lines outside its metrics JSON, the trace path
    replaced by a placeholder."""
    return [ln.replace(trace, "TRACE") for ln in stdout.splitlines()
            if ln and ln[0] not in " {}"]


def _completed(m: dict) -> int:
    if "migrations" in m:          # --disagg
        return m["migrations"]["delivered"]
    return sum(c["completed"] for c in m["_class"].values())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every process of this file, side by side: the sim pairs, the port's
    torch-backend flag sets and the reference's loop over the same."""
    trace = str(tmp_path_factory.mktemp("trace") / "trace.json")
    torch_flags = {n: [trace if a == "TRACE" else a for a in f]
                   for n, f in TORCH_FLAGS.items()}
    ref_argv = {n: SMALL + [trace + ".ref" if a == trace else a for a in f]
                for n, f in torch_flags.items()}
    # the reference's flag sets in three processes (its engine's jit
    # dominates), started first
    jobs = {("ref", i): ["-c", _REF_LOOP, json.dumps(
        {n: ref_argv[n] for n in group})]
        for i, group in enumerate((("paged", "paged_hits", "moe_mla"),
                                   ("dense", "online", "paged_swap"),
                                   ("disagg", "trace", "chaos")))}
    for name, flags in SIM_FLAGS.items():
        jobs[("sim-ref", name)] = ["-m", "repro.launch.serve", "--backend",
                                   "sim"] + SMALL + flags
        jobs[("sim-port", name)] = ["-m", "repro_torch.launch.serve",
                                    "--backend", "sim"] + SMALL + flags
    for name, flags in torch_flags.items():
        jobs[("port", name)] = ["-m", "repro_torch.launch.serve",
                                "--torch-device", "cpu"] + SMALL + flags
    with ThreadPoolExecutor(max_workers=5) as pool:
        futs = {k: pool.submit(_run, a) for k, a in jobs.items()}
        out = {k: f.result() for k, f in futs.items()}
    for i in range(3):
        rc, stdout, err = out.pop(("ref", i))
        assert rc == 0, err
        for name, text in json.loads(
                stdout.strip().splitlines()[-1]).items():
            out[("ref", name)] = (0, text, "")
    out["trace"] = trace
    return out


@pytest.mark.parametrize("flags", sorted(SIM_FLAGS))
def test_sim_stdout_equals_reference(runs, flags):
    ref = runs[("sim-ref", flags)]
    port = runs[("sim-port", flags)]
    assert ref[0] == 0, ref[2]
    assert port[0] == 0, port[2]
    assert "requests completed in sim:" in port[1]
    assert port[1] == ref[1]


@pytest.mark.parametrize("flags", sorted(TORCH_FLAGS))
def test_torch_backend_flag_set(runs, flags):
    rc, stdout, err = runs[("port", flags)]
    assert rc == 0, err
    m = _metrics(stdout)
    ref_out = runs[("ref", flags)][1]
    ref = _metrics(ref_out)
    assert _keys(m) == _keys(ref)
    if flags != "chaos":
        assert _fixed(m) == _fixed(ref)
        trace = runs["trace"]
        assert _summary(stdout, trace) == _summary(
            ref_out.replace(trace + ".ref", trace), trace)
    # 2 requests a tenant (--disagg serves the LS tenants only)
    assert _completed(m) == (2 if flags == "disagg" else 4)
    if flags != "disagg":
        assert "engine quanta executed:" in stdout
    ls = m.get("ls:qwen3-1.7b", {})
    if flags == "paged_hits":
        assert ls["prefix_cache"]["hits"] >= 1
    if flags == "paged_swap":
        assert ls["swap"]["swap_outs"] >= 1 and ls["swap"]["swap_ins"] >= 1


def test_trace_passes_schema(runs):
    from repro_torch.obs import schema
    assert runs[("port", "trace")][0] == 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert schema._main([runs["trace"] + ".jsonl"]) == 0
    assert buf.getvalue().startswith("ok:")
