"""Discrete-event contention simulator for a shared accelerator.

Reproduces the paper's end-to-end scenarios (Figs. 5/6/11/12/14) with the
assigned architectures as workloads: LS/BE tenants submit inference requests;
each request is a sequence of kernels whose (flops, bytes) come from the
analytic cost model; co-executing kernels contend for compute partitions
(ComputePolicy — temporal / spatial(MPS+) / interference-aware(Orion) /
SGDRC elastic) and for VRAM-channel bandwidth (uncolored: demand-proportional
sharing + L2-thrashing penalty between classes; colored: hard Ch_BE split, no
cross-class thrashing, +SPT overhead on memory-bound kernels).
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from .compute import ComputePolicy
from .costmodel import model_costs
from ..configs.base import ModelConfig
from ..obs.metrics import percentile as _pctl


@dataclass(frozen=True)
class DeviceSpec:
    name: str
    peak_flops: float
    hbm_bw: float
    num_channels: int
    thrash: float = 1.45       # cross-class L2/DRAM interference multiplier


TPU_V5E = DeviceSpec("tpu-v5e", 197e12, 819e9, 16)
GPU_DEVICES = {
    "tesla-p40": DeviceSpec("tesla-p40", 11.8e12, 346e9, 12, 1.35),
    "tesla-v100": DeviceSpec("tesla-v100", 112e12, 897e9, 32, 1.5),
    "rtx-a2000": DeviceSpec("rtx-a2000", 32e12, 360e9, 6, 1.55),
    "rtx-a5500": DeviceSpec("rtx-a5500", 88e12, 768e9, 12, 1.7),
    "tpu-v5e": TPU_V5E,
}


@dataclass
class Kernel:
    flops: float
    bytes: float
    memory_bound: bool


def request_kernels(cfg: ModelConfig, B: int, S: int, mode: str,
                    dev: DeviceSpec, max_kernels: int = 24,
                    kv_write=None, prefix: int = 0,
                    chunk=None, swap_bytes: int = 0,
                    xfer_bytes: int = 0, tile=None) -> List[Kernel]:
    """``chunk`` (prefill only) models chunked prefill: the op stream is
    coalesced into one kernel per prompt chunk — each kernel carries the
    chunk's re-read tax from the cost model, and the kernel boundary is the
    simulator's preemption point (the engine-quantum analogue), which is
    what lets a co-scheduled LS tenant interleave mid-prompt. ``tile``
    (prefill only) refines that boundary below the chunk: one kernel per
    ``tile`` tokens — the sub-chunk preemption point — while the cost model
    still charges the cache re-read tax at ``chunk`` granularity, so a
    finer tile buys preemption latency without re-pricing the prefill.
    ``swap_bytes`` adds the request's KV host-tier fault traffic as a
    zero-FLOP memory-bound op, charged at the owning class's bandwidth
    split like any other byte; ``xfer_bytes`` does the same for the
    request's cross-device KV page-group transfer (disaggregated
    prefill/decode over core.interconnect), so multi-device runs charge
    transfer time to the owning class."""
    ops = model_costs(cfg, B, S, mode, kv_write=kv_write, prefix=prefix,
                      chunk=chunk, swap_bytes=swap_bytes,
                      xfer_bytes=xfer_bytes)
    span = max(S - min(int(prefix), max(S - 1, 0)), 1)
    gran = None
    if mode == "prefill":
        gran = int(chunk) if chunk else None
        if tile:
            gran = int(tile) if gran is None else min(gran, int(tile))
    if gran and gran < span:
        n_chunks = -(-span // gran)
        per = max(1, len(ops) // n_chunks)
    else:
        per = max(1, len(ops) // max_kernels)
    out: List[Kernel] = []
    for i in range(0, len(ops), per):
        grp = ops[i:i + per]
        f = sum(o.flops for o in grp)
        b = sum(o.bytes for o in grp)
        out.append(Kernel(f, b, b / dev.hbm_bw > f / dev.peak_flops))
    return out


@dataclass
class Tenant:
    name: str
    priority: str              # LS | BE
    kernels: List[Kernel]      # one request's kernel sequence
    arrivals: Optional[List[float]] = None   # LS: request arrival times
    closed_loop: bool = False  # BE: always another request
    # chunked-prefill phase mark: the first ``prefill_kernels`` kernels are
    # the request's prompt-processing phase (one kernel per prefill chunk
    # when the engine chunks); kernels past it are decode steps, so the
    # simulator can report TTFT (prefill-phase completion) and TBT
    # (decode-kernel completion gaps) per request
    prefill_kernels: Optional[int] = None
    # runtime state
    queue: List[float] = field(default_factory=list)
    k_idx: int = 0
    cur_started: float = 0.0
    cur_remaining: float = 1.0   # fraction of current kernel left
    active_since: Optional[float] = None
    suspended: bool = False      # temporal multiplexing: preempted mid-request
    latencies: List[float] = field(default_factory=list)
    completed: int = 0
    ttfts: List[float] = field(default_factory=list)
    tbt_gaps: List[float] = field(default_factory=list)
    _last_tok_t: float = 0.0

    @property
    def is_ls(self):
        return self.priority == "LS"


class GPUSimulator:
    """``controller`` makes the policy *time-varying*: any object with a
    ``decide(LoadSignal, t) -> plan`` method (``core.controller``'s
    OnlineController or PlanSchedule) is consulted every ``control_dt``
    simulated seconds and its plan's ``sm_be``/``ch_be`` are adopted at that
    boundary — never mid-event, so in-flight kernels finish their current
    rate segment first. Event steps are capped at control boundaries, which
    bounds the LS snap-back delay (an LS request arriving under the lending
    plan waits at most one control tick for its resources)."""

    def __init__(self, dev: DeviceSpec, policy: ComputePolicy,
                 coloring: bool = False, ch_be: float = 1 / 3,
                 spt_overhead: float = 0.007, pcie_coupled=None,
                 controller=None, control_dt: float = 0.02,
                 migration_bytes: float = 0.0, faults=None, tracer=None):
        self.dev = dev
        # telemetry (repro.obs.Tracer): plan adoptions emit kind="plan"
        # instants with the controller's cause; kernel completions emit
        # kind="kernel" instants (debug level). Timestamps are simulated
        # seconds — the sim never reads a wall clock.
        self.tracer = tracer
        self._last_plan = None
        if tracer is not None and faults is not None \
                and getattr(faults, "tracer", None) is None:
            faults.tracer = tracer
        self.policy = policy
        self.coloring = coloring
        self.ch_be = ch_be
        self.spt_overhead = spt_overhead
        self.controller = controller
        self.control_dt = control_dt
        # chaos plane (serving.faults.FaultPlane): transient bandwidth
        # degradation / thermal throttle / per-tenant straggler windows are
        # charged through _rates, and event steps are capped at fault
        # boundaries so no rate segment spans a fault transition
        self.faults = faults
        # resplit-aware migration costing: bytes of KV pages that must move
        # per unit of |Δch_be| at a plan transition (0 = the historical
        # free-bookkeeping model). The move occupies the memory system for
        # bytes/hbm_bw seconds: running kernels stall for that long, so the
        # tidal controller's churn is charged to the window's HBM budget.
        self.migration_bytes = migration_bytes
        self.migrated_bytes = 0.0

    # ------------------------------------------------------------------
    def _admit_orion(self, k: Kernel, n_ls_active: int) -> bool:
        """Interference-aware admission (Orion-style): a BE kernel may
        co-execute with LS work only if it is (a) not memory-bound (no DRAM
        contention with LS) and (b) short enough to fit the LS latency budget
        — the paper reports 83.4% of BE kernels carry >=1 such constraint,
        and the budget tightens as LS concurrency grows (Fig. 6)."""
        if n_ls_active == 0:
            return True
        if k.memory_bound:
            return False
        dur = max(k.flops / self.dev.peak_flops, k.bytes / self.dev.hbm_bw)
        return dur < 4e-3 / n_ls_active

    def _rates(self, running: List[Tenant], now: float = 0.0):
        """Per-tenant kernel duration at the current co-execution state.
        Injected faults scale the device here: ``bw_degrade`` multiplies
        HBM bandwidth, ``thermal_throttle`` multiplies peak FLOPs, and a
        ``straggler`` window stretches the target tenant's kernels —
        faults slow work down, they never lose it."""
        peak_flops, hbm_bw = self.dev.peak_flops, self.dev.hbm_bw
        if self.faults is not None:
            hbm_bw *= self.faults.bw_scale(now)
            peak_flops *= self.faults.flops_scale(now)
        ls = [t for t in running if t.is_ls]
        be = [t for t in running if not t.is_ls]
        ls_f, be_f = self.policy.alloc(bool(ls), bool(be))
        out: Dict[str, float] = {}
        # occupancy-proportional SM sharing (multistream, no isolation)
        occ = None
        if ls_f < 0:
            flops = {t.name: max(t.kernels[t.k_idx].flops, 1.0)
                     for t in running}
            tot = sum(flops.values())
            occ = {n: f / tot for n, f in flops.items()}
        # bandwidth split
        demands = {t.name: t.kernels[t.k_idx].bytes for t in running}
        tot_dem = sum(demands.values()) or 1.0
        for t in running:
            k = t.kernels[t.k_idx]
            if occ is not None:
                sm = occ[t.name]
            else:
                sm = (ls_f / max(len(ls), 1)) if t.is_ls else \
                    (be_f / max(len(be), 1))
            sm = max(sm, 1e-6)
            if self.coloring:
                share = (1 - self.ch_be) if t.is_ls else self.ch_be
                bw = hbm_bw * share / max(
                    len(ls) if t.is_ls else len(be), 1)
                thrash = 1.0
                spt = 1.0 + (self.spt_overhead if k.memory_bound else 0.0)
            else:
                bw = hbm_bw * demands[t.name] / tot_dem
                cross = (ls and be)
                thrash = (self.dev.thrash
                          if (cross and k.memory_bound) else 1.0)
                spt = 1.0
            dur = max(k.flops / (peak_flops * sm),
                      k.bytes / max(bw, 1.0)) * thrash * spt
            if self.faults is not None:
                dur *= self.faults.straggler_slowdown(now, t.name)
            out[t.name] = max(dur, 1e-9)
        return out

    # ------------------------------------------------------------------
    def run(self, tenants: List[Tenant], horizon: float):
        t = 0.0
        for tn in tenants:
            tn.queue = list(tn.arrivals or [])
            if tn.closed_loop:
                tn.queue = [0.0]
            tn.k_idx, tn.active_since, tn.suspended = 0, None, False
            tn.cur_remaining = 1.0
            tn.latencies, tn.completed = [], 0
            tn.ttfts, tn.tbt_gaps = [], []

        def eligible(tn, now):
            # 1ns admission tolerance: a control-tick boundary landing an
            # epsilon before an arrival (float accumulation) must not push
            # the admission a whole tick out
            return tn.suspended or (tn.queue and tn.queue[0] <= now + 1e-9)

        def start(tn, now, delay):
            if tn.suspended:
                tn.suspended = False
            else:
                tn.cur_started = tn.queue.pop(0)
                tn.k_idx = 0
                tn.cur_remaining = 1.0
            tn.active_since = now + delay

        def admit(now):
            active = [x for x in tenants if x.active_since is not None]
            if self.policy.kind == "temporal":
                if active:
                    return
                cands = [x for x in tenants if eligible(x, now)]
                if cands:
                    cands.sort(key=lambda x: not x.is_ls)
                    start(cands[0], now, self.policy.ctx_switch_s)
                return
            n_ls = sum(1 for x in active if x.is_ls)
            for tn in tenants:
                if tn.active_since is not None or not eligible(tn, now):
                    continue
                k0 = tn.kernels[tn.k_idx if tn.suspended else 0]
                if (self.policy.kind == "orion" and not tn.is_ls
                        and not self._admit_orion(k0, n_ls)):
                    continue
                delay = (self.policy.preemption_delay(True)
                         if tn.is_ls and any(not x.is_ls for x in active)
                         else 0.0)
                start(tn, now, delay)
                if tn.is_ls:
                    n_ls += 1

        next_ctrl = 0.0

        def control(now):
            """Adopt the controller's plan for the current load (LS tenants
            with due or in-flight work count toward occupancy)."""
            nonlocal next_ctrl
            from .compute import LoadSignal
            n_q = sum(1 for tn in tenants if tn.is_ls
                      and tn.active_since is None and eligible(tn, now))
            n_a = sum(1 for tn in tenants
                      if tn.is_ls and tn.active_since is not None)
            sig = LoadSignal(ls_queued=n_q, ls_active=n_a,
                             ls_slots=max(1, sum(1 for tn in tenants
                                                 if tn.is_ls)),
                             window_s=self.control_dt)
            plan = self.controller.decide(sig, now)
            if self.tracer is not None and plan is not self._last_plan:
                cause = getattr(self.controller, "last_cause", None)
                if cause is None:
                    cause = "initial" if self._last_plan is None else "replan"
                self.tracer.instant("plan", cause, now, "sim/plan",
                                    sm_be=float(plan.sm_be),
                                    ch_be=float(plan.ch_be))
                self._last_plan = plan
            self.policy.update(sm_be=plan.sm_be)
            if plan.ch_be != self.ch_be and self.migration_bytes > 0:
                moved = self.migration_bytes * abs(plan.ch_be - self.ch_be)
                self.migrated_bytes += moved
                stall = moved / self.dev.hbm_bw
                for tn in tenants:
                    if tn.active_since is not None:
                        tn.active_since = max(tn.active_since, now + stall)
            self.ch_be = plan.ch_be
            next_ctrl = now + self.control_dt

        while t < horizon:
            if self.controller is not None and t + 1e-12 >= next_ctrl:
                control(t)
            admit(t)
            running = [tn for tn in tenants
                       if tn.active_since is not None and tn.active_since <= t]
            pending_act = [tn.active_since for tn in tenants
                           if tn.active_since is not None and tn.active_since > t]
            if not running:
                nxt = pending_act + [tn.queue[0] for tn in tenants
                                     if tn.queue and tn.queue[0] > t]
                if not nxt:
                    break
                t = min(nxt)
                continue
            durs = self._rates(running, t)
            dt = min(tn.cur_remaining * durs[tn.name] for tn in running)
            arr = [tn.queue[0] - t for tn in tenants
                   if tn.queue and tn.active_since is None] + \
                  [a - t for a in pending_act]
            arr = [a for a in arr if a > 1e-12]   # only future events
            if arr:
                dt = min(dt, min(arr))
            if self.controller is not None:
                # never integrate across a control boundary: the plan (and
                # with it every co-execution rate) may change there
                dt = min(dt, max(next_ctrl - t, 1e-9))
            if self.faults is not None:
                # likewise never integrate across a fault boundary: the
                # degraded rates apply exactly within their windows
                b = self.faults.next_boundary(t)
                if b < float("inf"):
                    dt = min(dt, max(b - t, 1e-9))
            dt = min(dt, horizon - t + 1e-9)
            for tn in running:
                tn.cur_remaining -= dt / durs[tn.name]
            t += dt
            ls_waiting = any(tn.is_ls and eligible(tn, t) for tn in tenants)
            n_ls_now = sum(1 for x in tenants
                           if x.is_ls and x.active_since is not None)
            for tn in running:
                if tn.cur_remaining <= 1e-9:
                    tn.k_idx += 1
                    tn.cur_remaining = 1.0
                    if self.tracer is not None \
                            and self.tracer.enabled("kernel"):
                        self.tracer.instant(
                            "kernel", f"k{tn.k_idx - 1}", t,
                            f"sim/{tn.name}", tenant=tn.name,
                            k_idx=tn.k_idx - 1)
                    # phase marks: prefill-phase completion is the request's
                    # TTFT; decode-kernel completion gaps are its TBT
                    if tn.prefill_kernels is not None:
                        if tn.k_idx == tn.prefill_kernels:
                            tn.ttfts.append(t - tn.cur_started)
                            tn._last_tok_t = t
                        elif tn.k_idx > tn.prefill_kernels:
                            tn.tbt_gaps.append(t - tn._last_tok_t)
                            tn._last_tok_t = t
                    if tn.k_idx >= len(tn.kernels):
                        tn.latencies.append(t - tn.cur_started)
                        tn.completed += 1
                        tn.active_since = None
                        tn.k_idx = 0
                        if tn.closed_loop:
                            tn.queue.append(t)
                    elif (self.policy.kind == "temporal" and not tn.is_ls
                          and ls_waiting):
                        tn.active_since = None     # yield at kernel boundary
                        tn.suspended = True
                    elif (self.policy.kind == "orion" and not tn.is_ls
                          and not self._admit_orion(tn.kernels[tn.k_idx],
                                                    n_ls_now + ls_waiting)):
                        # kernel-granularity re-admission: the next BE kernel
                        # violates a co-execution constraint -> yield
                        tn.active_since = None
                        tn.suspended = True
        return SimResult(tenants, min(t, horizon))


@dataclass
class SimResult:
    tenants: List[Tenant]
    horizon: float

    def ls_p99(self) -> float:
        lat = [l for tn in self.tenants if tn.is_ls for l in tn.latencies]
        return float(_pctl(lat, 99)) if lat else float("nan")

    def ls_p99_of(self, name) -> float:
        tn = next(x for x in self.tenants if x.name == name)
        return (float(_pctl(tn.latencies, 99))
                if tn.latencies else float("nan"))

    def be_throughput(self, batch: int = 1) -> float:
        done = sum(tn.completed for tn in self.tenants if not tn.is_ls)
        return done * batch / max(self.horizon, 1e-9)

    def ls_ttft_p99(self) -> float:
        """p99 prefill-phase completion time over LS tenants carrying a
        ``prefill_kernels`` phase mark (NaN without samples)."""
        ts = [x for tn in self.tenants if tn.is_ls for x in tn.ttfts]
        return float(_pctl(ts, 99)) if ts else float("nan")

    def ls_tbt_p99(self) -> float:
        """p99 decode inter-kernel gap over LS tenants (NaN without
        samples) — the simulator-side TBT the chunked BE prefill is meant
        to protect."""
        gs = [x for tn in self.tenants if tn.is_ls for x in tn.tbt_gaps]
        return float(_pctl(gs, 99)) if gs else float("nan")


# ---------------------------------------------------------------------------
# arrival traces
# ---------------------------------------------------------------------------

def poisson_trace(qps: float, horizon: float, seed: int = 0) -> List[float]:
    rng = np.random.default_rng(seed)
    out, t = [], 0.0
    while True:
        t += rng.exponential(1.0 / qps)
        if t >= horizon:
            return out
        out.append(t)


def apollo_like_trace(qps: float, horizon: float, seed: int = 0,
                      burstiness: float = 4.0) -> List[float]:
    """Bursty autonomous-driving-style trace: ON/OFF bursts with rate
    burstiness*qps during ON periods (Apollo trace stand-in)."""
    rng = np.random.default_rng(seed)
    out, t = [], 0.0
    while t < horizon:
        on = rng.exponential(0.05)
        end = min(t + on, horizon)
        while True:
            t += rng.exponential(1.0 / (qps * burstiness))
            if t >= end:
                break
            out.append(t)
        t = end + rng.exponential(0.05 * (burstiness - 1.0))
    return out
