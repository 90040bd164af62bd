"""Elastic compute multiplexing (§4, Fig. 8) — the TPU adaptation of the
paper's elastic SM multiplexing.

On GPU the mechanism is TPC masking (libsmctrl): a co-executing BE kernel may
use at most SM_BE% of TPCs, LS kernels preempt BE-occupied SMs (FLEP), and
idle LS partitions are lent to BE. On TPU a chip is one MXU, so the analogous
partitioning axes are (a) across-chip sub-meshes and (b) bounded tile quanta
within a chip (a BE kernel yields at tile-grid boundaries — see
kernels/dual_tenant_matmul for the grid-level SM_BE split).

This module is the *policy*: given who is running, what compute fraction does
each tenant's kernel get, and what preemption latency does an arriving LS
kernel pay. The contention simulator executes the policy.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class LoadSignal:
    """Windowed LS-load observation fed to the online controller: queue
    depth + slot occupancy over the last control window, plus the window's
    SLO attainment when the observer tracks one. Built by the serving
    engine (decode-slot granularity) and the simulator (tenant
    granularity) — the controller only sees this, never the backend."""
    ls_queued: int = 0          # LS requests waiting for a slot
    ls_active: int = 0          # LS requests currently holding a slot
    ls_slots: int = 1           # max LS concurrency (normalises the load)
    ls_slo_attainment: Optional[float] = None   # over the window, or None
    # windowed latency split by phase: p99 time-to-first-token (admission +
    # prefill — what a monolithic co-located prefill inflates) and p99
    # time-between-tokens (decode cadence — what chunked prefill protects);
    # None when the window produced no sample
    ls_ttft_p99_ms: Optional[float] = None
    ls_tbt_p99_ms: Optional[float] = None
    window_s: float = 0.0

    @property
    def ls_load(self) -> float:
        """0 when LS is fully idle, else demand over capacity in (0, 1]."""
        demand = self.ls_queued + self.ls_active
        if demand <= 0:
            return 0.0
        return min(1.0, demand / max(self.ls_slots, 1))


@dataclass
class ComputePolicy:
    kind: str = "sgdrc"        # sgdrc | temporal | spatial | orion
    sm_be: float = 0.30        # BE compute fraction while LS is active (§5.3)
    tile_quantum_s: float = 25e-6   # BE preemption granularity (one tile)
    ctx_switch_s: float = 1e-3      # temporal-multiplexing context switch
    mps_split: float = 0.5          # MPS+ static halves

    def alloc(self, ls_active: bool, be_active: bool):
        """Returns (ls_frac, be_frac) of compute while both classes have
        runnable kernels; either may be 0 when idle. The "multistream" kind
        returns (-1,-1): occupancy-proportional sharing (big BE kernels hog
        SMs — no isolation at all), resolved by the simulator."""
        if self.kind == "multistream":
            if ls_active and be_active:
                return (-1.0, -1.0)
            return (1.0 if ls_active else 0.0, 1.0 if be_active else 0.0)
        if self.kind == "temporal":
            # exclusive execution; arbitration handled by the simulator
            return (1.0, 0.0) if ls_active else (0.0, 1.0)
        if self.kind == "spatial":
            if ls_active and be_active:
                return (self.mps_split, self.mps_split)
            return (1.0 if ls_active else 0.0, 1.0 if be_active else 0.0)
        if self.kind == "orion":
            # co-execution permitted only for "compatible" BE kernels; the
            # simulator gates BE admission — when admitted, BE runs unmasked
            if ls_active and be_active:
                return (1.0, 1.0)
            return (1.0 if ls_active else 0.0, 1.0 if be_active else 0.0)
        # sgdrc: BE masked to sm_be% of partitions while LS is active (LS
        # keeps the remainder); elastic lending when either side idles
        if ls_active and be_active:
            return (1.0 - self.sm_be, self.sm_be)
        return (1.0 if ls_active else 0.0, 1.0 if be_active else 0.0)

    def update(self, sm_be: Optional[float] = None) -> "ComputePolicy":
        """Quantum-boundary re-plan: mutate the BE compute quota in place.
        Callers (the simulator's control tick, the engine's step hook) only
        invoke this at step/tile-quantum boundaries, so an in-flight kernel
        keeps the rate it started with until the next scheduling event —
        the software analogue of libsmctrl remasking between launches."""
        if sm_be is not None:
            self.sm_be = float(min(max(sm_be, 0.0), 1.0))
        return self

    def preemption_delay(self, be_running: bool) -> float:
        """Extra latency an arriving LS kernel pays before its resources are
        available."""
        if self.kind == "temporal":
            return self.ctx_switch_s if be_running else 0.0
        if self.kind == "sgdrc":
            return self.tile_quantum_s if be_running else 0.0
        return 0.0


@dataclass
class ElasticMeshPartitioner:
    """Pod-level spatial isolation: assign disjoint sub-mesh slices to
    tenants; resize online as LS load changes (the across-chip face of
    elastic multiplexing; used by the serving engine at pod scale)."""
    total_chips: int
    min_ls: int = 1
    assignments: dict = field(default_factory=dict)

    def rebalance(self, ls_demand: float):
        """ls_demand in [0,1] -> chips for LS, remainder lent to BE.

        Clamp order matters: the LS floor (min_ls, itself capped at the mesh
        size) is applied *after* the keep-one-for-BE cap, so LS never drops
        below its floor and never exceeds the mesh — the old order handed LS
        ``min_ls`` chips even on meshes smaller than that, driving the BE
        assignment negative. BE keeps >= 1 chip only when one can be spared
        above the LS floor (a 1-chip mesh with min_ls >= 1 is all-LS)."""
        floor = min(self.min_ls, self.total_chips)
        cap = (self.total_chips - 1
               if self.total_chips - 1 >= floor else self.total_chips)
        want = int(round(ls_demand * self.total_chips))
        ls_chips = max(floor, min(cap, want))
        self.assignments = {"LS": ls_chips, "BE": self.total_chips - ls_chips}
        return dict(self.assignments)

    def rebalance_from_signal(self, sig: LoadSignal) -> dict:
        """Device lending from the same windowed :class:`LoadSignal` the
        online controller consumes: ``sig.ls_load`` (demand over capacity)
        becomes the LS slice demand, so moving a device between slices at a
        plan boundary is the cross-device analogue of a tidal ``sm_be``
        re-plan (disaggregated serving drives this with LS == the prefill
        slice). Same clamp guarantees as :meth:`rebalance`: the device
        count is conserved and the LS slice never drops below its floor."""
        return self.rebalance(sig.ls_load)
