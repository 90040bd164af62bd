"""SGDRC control plane (§4/§5.3): offline plan search + online tidal re-plan.

Two phases, mirroring the paper's software-defined split:

**Offline** — :func:`grid_search` profiles a model's ops with the analytic
cost model, marks memory-bound tensors for isolation (DRAM throughput >
Thres_DRAM%), and grid-searches (SM_BE, Ch_BE, Thres_DRAM) maximizing BE
resource grants subject to LS kernel latency inflation <= 25% vs running
alone (the paper's constraint; their search lands at SM_BE=30, Ch_BE=1/3,
Thres_DRAM=40). :func:`frontier_search` generalises the single point into a
*frontier* of :class:`ResourcePlan` candidates, one per LS-load regime: the
pairwise-inflation constraint is evaluated at increasing LS concurrency, so
high-load regimes land on conservative plans and the zero-load regime is the
full tidal-lending plan (``sm_be = 1``, BE takes every VRAM channel).

**Online** — :class:`OnlineController` watches a windowed load signal from
the serving engine or the simulator (:class:`~repro.core.compute.LoadSignal`:
LS queue depth, slot occupancy, windowed SLO attainment) and transitions
between frontier plans at *step boundaries* (engine quantum / simulator
control tick — never mid-kernel):

  * relaxation toward BE generosity (LS ebbing) moves one regime per
    decision and requires ``idle_patience`` consecutive idle windows before
    full lending — hysteresis against trace noise;
  * tightening (LS flowing back, or windowed SLO attainment dropping under
    ``slo_guard``) snaps straight to the regime's plan, so the LS preemption
    delay is bounded by one control interval (the tidal snap-back).

Consumers call ``decide(signal, t) -> ResourcePlan`` and apply the returned
``sm_be`` to the compute policy and ``ch_be`` to the colored allocator / KV
pools (``ServingEngine.apply_plan``; ``GPUSimulator(controller=...)``).
:class:`PlanSchedule` exposes the same ``decide`` interface for replaying a
fixed (t, plan) schedule — the static-vs-online ablation axis.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .compute import ComputePolicy, LoadSignal
from .costmodel import model_costs
from .simulator import DeviceSpec, GPUSimulator, Kernel, Tenant, request_kernels
from ..configs.base import ModelConfig


@dataclass
class ResourcePlan:
    sm_be: float
    ch_be: float
    thres_dram: float
    ls_channels: tuple
    be_channels: tuple
    max_ls_inflation: float
    # BE prefill tokens per engine quantum (None = unthrottled): the
    # serving scheduler's chunked-prefill throttle, so a plan can slow BE
    # prompt processing — the co-location that inflates LS TBT — without
    # also cutting BE's SM share or decode cadence
    prefill_budget: Optional[int] = None
    # host-tier budget: max KV pages faulted back from the host per engine
    # quantum (None = the engine's own default). The swap_pcie op is
    # already class-charged, so capping BE swap-in bandwidth here lets a
    # tidal snap-back trade BE's host-fault traffic against ch_be instead
    # of letting a BE swap storm ride the shrunken channel split
    swap_quantum_pages: Optional[int] = None


def memory_bound_ops(cfg: ModelConfig, B: int, S: int, mode: str,
                     dev: DeviceSpec, thres_dram: float) -> List[str]:
    """Ops whose DRAM throughput exceeds thres_dram% of peak when run alone
    (Nsight-Compute analogue). These get SPT-colored tensors."""
    out = []
    for op in model_costs(cfg, B, S, mode):
        t = max(op.flops / dev.peak_flops, op.bytes / dev.hbm_bw)
        dram_util = (op.bytes / dev.hbm_bw) / max(t, 1e-12)
        if dram_util > thres_dram:
            out.append(op.name)
    return out


def _pair_inflation(dev: DeviceSpec, ls_k: Kernel, be_k: Kernel,
                    sm_be: float, ch_be: float,
                    ls_concurrency: int = 1) -> float:
    """LS kernel latency inflation when co-executed with a BE kernel under
    the candidate setting (coloring on). ``ls_concurrency`` co-runs that many
    identical LS kernels — the load axis the frontier search sweeps."""
    solo = max(ls_k.flops / dev.peak_flops, ls_k.bytes / dev.hbm_bw)
    sim = GPUSimulator(dev, ComputePolicy(kind="sgdrc", sm_be=sm_be),
                       coloring=True, ch_be=ch_be)
    tenants = [Tenant(f"ls{i}", "LS", [ls_k], arrivals=[0.0])
               for i in range(max(ls_concurrency, 1))]
    tenants.append(Tenant("be", "BE", [be_k], arrivals=[0.0]))
    res = sim.run(tenants, horizon=10.0)
    lat = res.tenants[0].latencies
    return (lat[0] / solo) if lat else float("inf")


def grid_search(dev: DeviceSpec, ls_cfgs: Sequence[ModelConfig],
                be_cfgs: Sequence[ModelConfig], *,
                max_inflation: float = 1.25,
                sm_grid=(0.1, 0.2, 0.3, 0.4, 0.5),
                ch_grid=(1 / 6, 1 / 4, 1 / 3, 1 / 2),
                thres_grid=(0.2, 0.4, 0.6),
                pairs_per_model: int = 6, seed: int = 0,
                ls_concurrency: int = 1,
                prefill_budget: Optional[int] = None,
                prefix_hit: float = 0.0,
                swap_quantum_pages: Optional[int] = None) -> ResourcePlan:
    """``prefix_hit`` is the measured prefix-cache hit rate (hit tokens /
    prompt tokens, e.g. :func:`measured_prefix_hit`): the BE profiling pool
    charges prefill only for the uncached suffix, so a warm cache stops the
    planner from over-reserving prefill bandwidth against dense prompt
    traffic that never materialises — warm-cache plans are (weakly) more
    BE-generous at the same LS inflation bound."""
    rng = np.random.default_rng(seed)
    hit = min(max(float(prefix_hit), 0.0), 1.0)
    ls_pool = [k for cfg in ls_cfgs
               for k in request_kernels(cfg, 1, 128, "prefill", dev)]
    be_pool = [k for cfg in be_cfgs
               for k in request_kernels(cfg, 8, 256, "prefill", dev,
                                        prefix=int(hit * 256))]
    n = min(len(ls_pool) * len(be_pool),
            pairs_per_model * len(ls_cfgs) * len(be_cfgs))
    pairs = [(ls_pool[rng.integers(len(ls_pool))],
              be_pool[rng.integers(len(be_pool))]) for _ in range(n)]

    best, best_score = None, -1.0
    for sm_be, ch_be, thres in itertools.product(sm_grid, ch_grid, thres_grid):
        worst = max(_pair_inflation(dev, lk, bk, sm_be, ch_be, ls_concurrency)
                    for lk, bk in pairs)
        if worst <= max_inflation:
            score = sm_be + ch_be + thres   # paper: maximize all three
            if score > best_score:
                best_score = score
                best = (sm_be, ch_be, thres, worst)
    if best is None:   # fall back to the most conservative point
        sm_be, ch_be, thres = min(sm_grid), min(ch_grid), min(thres_grid)
        worst = max(_pair_inflation(dev, lk, bk, sm_be, ch_be, ls_concurrency)
                    for lk, bk in pairs)
        best = (sm_be, ch_be, thres, worst)
    sm_be, ch_be, thres, worst = best
    n_be = max(1, int(round(dev.num_channels * ch_be)))
    return ResourcePlan(
        sm_be=sm_be, ch_be=ch_be, thres_dram=thres,
        ls_channels=tuple(range(dev.num_channels - n_be)),
        be_channels=tuple(range(dev.num_channels - n_be, dev.num_channels)),
        max_ls_inflation=worst, prefill_budget=prefill_budget,
        swap_quantum_pages=swap_quantum_pages)


# ---------------------------------------------------------------------------
# plan frontier (offline phase of the online control plane)
# ---------------------------------------------------------------------------

@dataclass
class PlanFrontier:
    """Candidate plans indexed by LS-load regime.

    ``entries`` is ``[(ls_load_level, plan)]`` sorted ascending by load;
    entry 0 is the most BE-generous (usually the tidal-lending plan for
    load 0) and the last entry the most conservative. ``plan_for(load)``
    returns the most generous plan whose regime still covers ``load``.
    """
    entries: List[Tuple[float, ResourcePlan]]

    def __post_init__(self):
        assert self.entries, "empty frontier"
        self.entries = sorted(self.entries, key=lambda e: e[0])

    def __len__(self):
        return len(self.entries)

    def plan_for(self, load: float) -> ResourcePlan:
        for lvl, plan in self.entries:
            if load <= lvl + 1e-9:
                return plan
        return self.entries[-1][1]

    def index_of(self, plan: ResourcePlan) -> int:
        for i, (_, p) in enumerate(self.entries):
            if p is plan:
                return i
        raise ValueError("plan not on this frontier")

    @property
    def plans(self) -> List[ResourcePlan]:
        return [p for _, p in self.entries]


def lending_plan(base: ResourcePlan,
                 num_channels: Optional[int] = None) -> ResourcePlan:
    """The idle-regime plan: full tidal lending. BE takes every quantum
    (``sm_be = 1``) and every VRAM channel (``ch_be = 1``; LS keeps its
    channel *assignment* so snap-back never migrates LS pages — BE merely
    borrows free pages off the LS set while LS is idle). No LS kernel
    co-runs under this plan, so the recorded inflation is 1x by definition."""
    C = num_channels or (len(base.ls_channels) + len(base.be_channels))
    return replace(base, sm_be=1.0, ch_be=1.0,
                   be_channels=tuple(range(C)), max_ls_inflation=1.0,
                   prefill_budget=None, swap_quantum_pages=None)


def tidal_frontier(plan: ResourcePlan,
                   num_channels: Optional[int] = None) -> PlanFrontier:
    """Minimal two-regime frontier from one offline plan: the plan itself
    for any contended load, plus the full-lending plan for LS idle."""
    return PlanFrontier([(0.0, lending_plan(plan, num_channels)),
                         (1.0, plan)])


def frontier_search(dev: DeviceSpec, ls_cfgs: Sequence[ModelConfig],
                    be_cfgs: Sequence[ModelConfig], *,
                    load_grid: Sequence[float] = (0.34, 0.67, 1.0),
                    max_concurrency: int = 3,
                    max_inflation: float = 1.25,
                    sm_grid=(0.1, 0.2, 0.3, 0.4, 0.5),
                    ch_grid=(1 / 6, 1 / 4, 1 / 3, 1 / 2),
                    thres_grid=(0.2, 0.4, 0.6),
                    pairs_per_model: int = 6, seed: int = 0,
                    prefill_budget: Optional[int] = None,
                    prefix_hit: float = 0.0,
                    swap_quantum_pages: Optional[int] = None
                    ) -> PlanFrontier:
    """Offline phase of the online control plane: one grid search per LS-load
    regime. A regime at ``load`` is evaluated with ``round(load *
    max_concurrency)`` concurrent LS kernels in the pairwise-inflation
    constraint, so the feasible set shrinks as load grows; the zero-load
    regime is the analytic :func:`lending_plan` (no search needed — there is
    nothing to protect). ``prefill_budget`` attaches the serving scheduler's
    BE-prefill-tokens-per-quantum throttle to every *contended* regime (the
    lending plan stays unthrottled), so a tidal re-plan tightens BE prompt
    processing — the TBT hazard — together with BE's SM share, and releases
    both when LS ebbs. ``swap_quantum_pages`` does the same for BE's
    host-tier fault bandwidth (the ResourcePlan knob the engine applies at
    plan adoption); ``prefix_hit`` feeds the *measured* prefix-cache hit
    rate into every regime's profiling pool (see :func:`grid_search`), so
    the frontier stops assuming dense prefill traffic when the cache is
    warm."""
    entries: List[Tuple[float, ResourcePlan]] = []
    for load in sorted(set(load_grid)):
        assert load > 0, "load 0 is the lending plan; keep it off load_grid"
        conc = max(1, int(round(load * max_concurrency)))
        plan = grid_search(dev, ls_cfgs, be_cfgs,
                           max_inflation=max_inflation, sm_grid=sm_grid,
                           ch_grid=ch_grid, thres_grid=thres_grid,
                           pairs_per_model=pairs_per_model, seed=seed,
                           ls_concurrency=conc,
                           prefill_budget=prefill_budget,
                           prefix_hit=prefix_hit,
                           swap_quantum_pages=swap_quantum_pages)
        entries.append((load, plan))
    entries.insert(0, (0.0, lending_plan(entries[-1][1], dev.num_channels)))
    return PlanFrontier(entries)


def measured_prefix_hit(engine) -> float:
    """Engine-wide measured prefix-cache hit rate (hit tokens over prompt
    tokens, across every tenant carrying a prefix cache) — the feedback
    the re-planning path hands :func:`frontier_search` via ``prefix_hit``,
    closing the loop the static planner left open (it assumed dense
    prefill traffic regardless of cache warmth). 0.0 with no prefix cache
    or no traffic yet."""
    hit = tot = 0
    for rt in engine.tenants.values():
        if rt.prefix is not None:
            st = rt.prefix.stats()
            hit += st["hit_tokens"]
            tot += st["prompt_tokens"]
    return hit / tot if tot else 0.0


# ---------------------------------------------------------------------------
# online controller
# ---------------------------------------------------------------------------

class OnlineController:
    """Tidal plan switching from a windowed load signal (module docstring).

    Stateful and backend-agnostic: the serving engine calls ``decide`` every
    ``control_interval`` quanta, the simulator every ``control_dt`` seconds.
    ``transitions`` records every adopted plan as ``(t, plan)``.
    """

    def __init__(self, frontier: PlanFrontier, *, idle_patience: int = 2,
                 slo_guard: float = 0.995):
        self.frontier = frontier
        self.idle_patience = idle_patience
        self.slo_guard = slo_guard
        self.plan = frontier.entries[-1][1]   # start most conservative
        self.transitions: List[Tuple[float, ResourcePlan]] = []
        self._idle_windows = 0
        #: cause of the most recent transition (telemetry; see
        #: ``repro.obs.schema.PLAN_CAUSES``): "slo_guard" | "hysteresis" |
        #: "lending" | "snap_back"; None while holding steady.
        self.last_cause: Optional[str] = None

    def decide(self, sig: LoadSignal, t: float = 0.0) -> ResourcePlan:
        self.last_cause = None
        load = sig.ls_load
        guarded = False
        if load > 0 and sig.ls_slo_attainment is not None \
                and sig.ls_slo_attainment < self.slo_guard:
            load = 1.0          # SLO pressure: treat as saturated
            guarded = True
        if load <= 0:
            self._idle_windows += 1
            if self._idle_windows < self.idle_patience:
                return self.plan
            target = self.frontier.plan_for(0.0)
        else:
            self._idle_windows = 0
            target = self.frontier.plan_for(load)
        if target is not self.plan:
            i_cur = self.frontier.index_of(self.plan)
            i_tgt = self.frontier.index_of(target)
            if i_tgt < i_cur:
                # relaxing toward BE generosity: one regime per decision
                target = self.frontier.entries[i_cur - 1][1]
                self.last_cause = ("lending" if self.frontier.index_of(
                    target) == 0 else "hysteresis")
            else:
                # tightening: jump straight to target (bounded snap-back)
                self.last_cause = "slo_guard" if guarded else "snap_back"
            self.plan = target
            self.transitions.append((t, target))
        return self.plan


class ChunkGovernor:
    """SLO-driven chunk sizing (the temporal twin of the tidal SM loop):
    AIMD on the engine's prefill ``chunk_size`` from the windowed LS TBT
    p99 the registry already computes for :class:`OnlineController`.

    A window whose TBT p99 exceeds ``target_tbt_ms`` halves the chunk
    (multiplicative decrease — a long co-scheduled prefill chunk is the
    direct cause of a decode-latency spike, so react in one window); after
    ``patience`` consecutive windows below ``headroom * target`` the chunk
    doubles back (additive-ish recovery — regrow BE prefill efficiency
    only once the SLO shows slack). The BE prefill budget rides along as
    ``budget_chunks`` chunks per quantum, so shrinking the chunk also
    shrinks how much BE prefill a quantum may interleave. Chunk sizes are
    clamped to [min_chunk, max_chunk]; windows with no TBT samples hold
    steady.

    ``update`` returns ``(chunk_size, prefill_budget)`` when the setting
    changed, else None — the engine logs adoptions as ``chunk_adapt``
    transitions.
    """

    def __init__(self, *, target_tbt_ms: float, chunk: int = 64,
                 min_chunk: int = 8, max_chunk: int = 512,
                 headroom: float = 0.5, patience: int = 2,
                 budget_chunks: int = 2):
        assert 0 < min_chunk <= chunk <= max_chunk
        assert 0.0 < headroom <= 1.0
        self.target_tbt_ms = float(target_tbt_ms)
        self.chunk = int(chunk)
        self.min_chunk = int(min_chunk)
        self.max_chunk = int(max_chunk)
        self.headroom = float(headroom)
        self.patience = max(int(patience), 1)
        self.budget_chunks = max(int(budget_chunks), 1)
        self._calm = 0
        self.shrinks = 0
        self.grows = 0
        #: (tbt_p99_ms, chunk) per consulted window (telemetry)
        self.history: List[Tuple[Optional[float], int]] = []

    @property
    def prefill_budget(self) -> int:
        return self.chunk * self.budget_chunks

    def update(self, tbt_p99_ms: Optional[float]):
        self.history.append((tbt_p99_ms, self.chunk))
        if tbt_p99_ms is None:
            return None
        prev = self.chunk
        if tbt_p99_ms > self.target_tbt_ms:
            self._calm = 0
            self.chunk = max(self.chunk // 2, self.min_chunk)
            if self.chunk != prev:
                self.shrinks += 1
        elif tbt_p99_ms <= self.headroom * self.target_tbt_ms:
            self._calm += 1
            if self._calm >= self.patience:
                self._calm = 0
                self.chunk = min(self.chunk * 2, self.max_chunk)
                if self.chunk != prev:
                    self.grows += 1
        else:
            self._calm = 0
        if self.chunk == prev:
            return None
        return self.chunk, self.prefill_budget

    def stats(self) -> dict:
        return {"chunk": self.chunk, "shrinks": self.shrinks,
                "grows": self.grows, "windows": len(self.history),
                "target_tbt_ms": self.target_tbt_ms}


@dataclass
class PlanSchedule:
    """Fixed time-indexed plan sequence with the controller ``decide``
    interface — replays ``points = [(t_start, plan)]`` regardless of the
    load signal (the ablation baseline for static-vs-online comparisons)."""
    points: List[Tuple[float, ResourcePlan]]

    def __post_init__(self):
        assert self.points
        self.points = sorted(self.points, key=lambda e: e[0])
        self.transitions: List[Tuple[float, ResourcePlan]] = []
        self._current = self.points[0][1]
        self.last_cause: Optional[str] = None

    @property
    def plan(self) -> ResourcePlan:
        return self.points[0][1]

    def decide(self, sig: LoadSignal, t: float = 0.0) -> ResourcePlan:
        self.last_cause = None
        out = self.points[0][1]
        for t0, plan in self.points:
            if t0 <= t + 1e-12:
                out = plan
        if out is not self._current:
            self._current = out
            self.last_cause = "schedule"
            self.transitions.append((t, out))
        return out
