"""One run of a cell: set-up, pre-roll, the measured window, the drain,
the output check, and the metrics, as one result.

Set-up is everything from the process's start to the window's opening:
imports and the device's context, the kernels' libraries (built on the
first run of a checkout, then loaded from ``build/kernels/``), the
weights, a warm-up through the engine of the shapes the cell's traffic
uses (chunks of ``chunk_size``, a remainder, the one-token seeding chunk,
each tenant's decode), and the pre-roll: arrivals and the backlog start
``preroll_s`` before the window, so that it opens on a steady state.
"""
from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from . import check, driver, generator, spans
from . import weights as wmod
from .timeline import Timeline

#: BE requests the backlog can hand out
BACKLOG = 4096


@dataclass
class Run:
    """What the metrics' readers get."""
    timeline: Timeline
    cell: dict                     # the workload file's keys
    arch: Dict[str, dict]          # "LS", "BE" -> the model's arch
    dtype: str
    setup_s: float
    trace: Optional[spans.Trace] = None
    extra: dict = field(default_factory=dict)


def model_config(ModelConfig, m: dict, dtype: str):
    return ModelConfig(name=m["model"], family="dense",
                       activation_dtype=dtype, **m["arch"])


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_engine(conf: dict, seed: int, device: str):
    """The engine with both tenants, and the weights handed to it."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.controller import ResourcePlan
    from repro_torch.core.tenancy import TenantSpec
    from repro_torch.serving import ServingEngine
    e = conf["engine"]
    plan = ResourcePlan(sm_be=e["sm_be"], ch_be=e["ch_be"], thres_dram=0.4,
                        ls_channels=(), be_channels=(),
                        max_ls_inflation=0.25,
                        prefill_budget=e.get("prefill_budget"))
    eng = ServingEngine(max_seq=e["max_seq"], paged=e["paged"],
                        page_size=e["page_size"], use_flash=e["use_flash"],
                        chunk_size=e["chunk_size"],
                        slots_ls=conf["slots"]["ls"],
                        slots_be=conf["slots"]["be"], plan=plan,
                        torch_device=device)
    dtype = getattr(torch, conf["dtype"])
    params = {}
    for i, cls in enumerate(("LS", "BE")):
        m = conf[cls.lower()]
        params[cls] = wmod.make(m["arch"], seed, i, torch.device(device),
                                dtype)
        eng.add_tenant(TenantSpec(cls.lower(), cls),
                       model_config(ModelConfig, m, conf["dtype"]),
                       params=params[cls])
    return eng, params


def warm_up(eng, conf: dict):
    """Each tenant serves one request of two chunks and a remainder, so
    every kernel and GEMM shape family the traffic uses has run once."""
    L = 2 * conf["engine"]["chunk_size"] + 17
    for cls in ("ls", "be"):
        eng.submit(cls, [i % 97 + 1 for i in range(L)], max_new=3)
    eng.run_until_idle()


def run_cell(cat, name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_process: Optional[float] = None,
             chips: int = 1, override: Optional[dict] = None,
             control: bool = False):
    """One run of cell ``name``: (the result line's object, the ``Run``).
    ``override`` replaces keys of the
    workload file (the tools' sweeps: ``ls_rate``, ``be_waiting`` 0 for
    LS alone); ``control`` also reads the float8 control's gaps on the
    same sample (``run.extra["gaps"]``)."""
    t_process = time.perf_counter() if t_process is None else t_process
    on_cuda = device == "cuda"
    if on_cuda:
        torch.set_num_threads(1)
    entry = cat.cell(name)
    cell = dict(entry["cell"], **(override or {}))
    conf = cat.config(entry["config"])
    mix = cat.traffic(entry["traffic"])
    eng, params = build_engine(conf, seed, device)
    warm_up(eng, conf)
    if trace:
        spans.warm_profiler()
    if on_cuda:
        torch.cuda.synchronize()
    clock = eng.clock
    P, W, cap = cell["preroll_s"], float(seconds), cell["drain_cap_s"]
    segs = [("preroll", 0.0, P), ("window", P, W), ("drain", P + W, cap)]
    ls_reqs = generator.ls_stream(mix["ls"], cell["ls_rate"], segs,
                                conf["ls"]["arch"]["vocab_size"], seed,
                                mix["block_s"])
    be_reqs = generator.be_backlog(mix["be"], BACKLOG,
                                 conf["be"]["arch"]["vocab_size"], seed,
                                 joined=conf["slots"]["be"])
    rec = None
    t_start = clock()
    t0, t1 = t_start + P, t_start + P + W
    if trace:
        prof = cell["profile"]
        t_on = t0 + min(prof["start_s"], W / 4)
        rec = spans.Recorder(clock, t_on, prof["seconds"], t1)
        for cls in ("LS", "BE"):
            rec.wrap(eng.tenants[cls.lower()], cls, on_cuda)
    tl, ls_out, be_out = driver.drive(
        eng, "ls", "be", ls_reqs, be_reqs, t_start=t_start, t0=t0, t1=t1,
        cap_end=t1 + cap, be_waiting=cell.get("be_waiting",
                                              conf["slots"]["be"]),
        clock=clock,
        hook=None if rec is None else rec.hook)
    tr = rec.finish() if rec is not None else None
    dev_info = {"platform": "gpu" if on_cuda else "cpu",
                "kind": (torch.cuda.get_device_name(0) if on_cuda
                         else "cpu"),
                "count": chips,
                "memory_peak_bytes": (int(torch.cuda.max_memory_allocated())
                                      if on_cuda else 0)}
    if tr is not None:
        dev_info["busy_s"] = tr.busy_s
        dev_info["window_s"] = tr.window_s
    # the KV pool each tenant reserves, and the most of it the traffic held
    kv_filled = {}
    for cls in ("LS", "BE"):
        kv = eng.tenants[cls.lower()].kv
        if kv is not None:
            peak = tl.kv_pages_peak.get(cls, 0)
            kv_filled[cls] = {"pages_peak": peak, "pages_total": kv.n_pages,
                              "bytes_peak": peak * kv.bytes_per_page,
                              "bytes_total": kv.n_pages * kv.bytes_per_page}
    # the program's state goes before the reference runs
    del eng
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    checks, readings = {}, {}
    for cls, reqs in (("LS", ls_out), ("BE", be_out)):
        done = [r for r in reqs if r.t_done is not None and r.t_done >= t0]
        picked = check.sample(done, cell["check"]["min_tokens"], seed,
                              0 if cls == "LS" else 1)
        g = check.gaps(params[cls], conf[cls.lower()]["arch"],
                       picked, device, control=control)
        readings[cls] = g
        key = f"{cls.lower()}_logit_gap"
        _log(f"check {key}: {len(picked)} requests, "
             f"{int(g['tokens'])} served tokens read")
        checks[key] = {"value": g.get("served"),
                       "limit": cell["check"][key]}
    # a sample that is empty (no request came back) is not correct
    correct = all(c["value"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())
    run = Run(tl, cell, {c: conf[c.lower()]["arch"] for c in ("LS", "BE")},
              conf["dtype"], tl.t0 - t_process, tr, {"gaps": readings})
    metrics = {}
    for m in cat.metrics(name, trace):
        v = cat.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    due = tl.ls_due()
    out = {"correct": bool(correct), "attempted": len(due),
           "failed": sum(r.failed for r in due), "metrics": metrics,
           "device": dev_info}
    if tr is not None:
        out["breakdown"] = {"device_ops": tr.device_ops,
                            "idle_gaps": tr.idle_gaps}
    out["kv_filled"] = kv_filled
    out["checks"] = checks
    return out, run
