"""Fault-injection chaos plane for the SGDRC serving stack.

SGDRC's headline claim is a service-quality *guarantee* (99% LS SLO
attainment), but a guarantee is only meaningful under misbehaviour: a
production GPU throttles, a PCIe link stalls, a host tier drops a page, a
control loop misses its tick. This module provides the :class:`FaultPlane`
— a seeded, deterministic, scenario-scriptable injector — plus the
exceptions the recovery paths catch. Faults are *windows* (``active``:
anything overlapping ``[t, t+duration)``) or *points* (``fires``: consumed
once at the first query at or past ``t``). Every observed injection is
appended to ``log`` in observation order, so two runs of the same seeded
scenario over the same virtual clock produce identical logs — the
determinism contract the chaos bench asserts.

Failure model — injection point, recovery path, preserved invariant
===================================================================

``bw_degrade`` / ``thermal_throttle`` / ``straggler``
    *Injected at* ``GPUSimulator._rates``: HBM bandwidth scaled by
    ``magnitude`` (bw_degrade), peak FLOPs scaled (thermal_throttle), one
    tenant's kernel durations stretched (straggler, per ``target``). The
    event loop never integrates across a fault boundary
    (:meth:`FaultPlane.next_boundary`), so rates are exact within windows.
    *Recovery*: the controller's SLO guard sees the inflated LS latency in
    its windowed signal and tightens the plan. *Invariant*: simulated work
    is conserved — kernels slow down, none are lost.

``link_stall``
    *Injected at* ``PCIeCFS.run``: no fetch quantum starts inside a stall
    window; the bus resumes at the window edge. *Recovery*: transfers are
    delayed, never dropped; CFS vruntime fairness is unchanged.
    *Invariant*: every submitted copy still completes, in fair order.

``swap_write_fail``
    *Injected at* ``HostSwapPool.put``: raises :class:`HostTierFault`
    before any host state mutates. *Recovery*: the engine's ``_swap_out``
    drops the partial key group and falls back one ladder rung —
    preempt-restart (deterministic greedy decode recomputes the identical
    tokens). *Invariant*: the victim's device pages are released exactly
    once and its token stream is bit-equal to the fault-free run.

``swap_read_fail``
    *Injected at* ``HostSwapPool.get``: raises :class:`HostTierFault`
    before the host copy is consumed (the page stays resident for the
    retry). *Recovery*: bounded retry with exponential backoff
    (``swap_retry_limit``); exhausted retries drop the host keys and
    preempt-restart. *Invariant*: a SWAPPING request either resumes from
    its exact host pages or restarts from scratch — it never decodes
    against a partially-faulted page group.

``page_corrupt``
    *Injected at* ``HostSwapPool.get`` (point event): flips bytes in the
    stored host page, then the CRC32 checksum recorded at ``put`` time
    fails verification and :class:`ColdPageCorrupt` is raised; the corrupt
    host copy is discarded. *Recovery*: swap path → preempt-restart;
    prefix cold path → ``PrefixCache.fault_cold`` undoes the page adoption
    and the suffix is re-prefilled from tokens. *Invariant*: corrupt KV is
    never served — with recovery off (``verify=False``) the bench shows
    exactly the token divergence the checksum exists to prevent.

``alloc_fail``
    *Injected at* ``PagedKVCache.alloc_fault`` (queried at the scheduler's
    admission gate and the engine's growth pre-pass — deliberately *not*
    inside ``can_admit_pages``, which ``evict_until`` loops on: a hard
    failure there would flush the whole prefix tree). *Recovery*: paged
    admission and growth **defer** for the window (counted), they do not
    evict or shed. *Invariant*: no pages are allocated or freed because of
    a transient allocator fault; work resumes unchanged when it lifts.

``ctl_missed_tick`` / ``ctl_stale_signal``
    *Injected at* ``ServingEngine._maybe_control``: a due control tick is
    skipped (missed tick), or ``decide`` is fed the previous window's
    LoadSignal (stale signal). *Recovery*: the engine-side **watchdog** —
    when LS work exists but no LS quantum has executed for
    ``watchdog_quanta`` steps, the engine snaps to the conservative safe
    plan (``sm_be``/``ch_be`` floor: the frontier's most conservative
    entry, or :func:`safe_floor`). *Invariant*: the LS starvation interval
    under a stalled controller is bounded by ``watchdog_quanta`` engine
    quanta, independent of the controller's health.

Degradation ladder (per-tenant, driven by a fault budget)
=========================================================

Each recovery costs one point of the tenant's fault budget; every
``fault_budget`` points the engine takes the next ladder rung, trading
throughput for simplicity until faults stop:

    ``flash_to_dense``      flash decode/prefill kernels → dense attention
    ``swap_to_preempt``     host-tier swap-out → preempt-restart
    ``grow_to_full``        prompt-extent growth admission → full-extent
                            (whole-row-equivalent) reservation

Rungs are one-way within a run and reported in ``metrics()["faults"]``
(``degraded`` per tenant, plus injected/recovered/shed/rejected counts).
Satellite recovery paths that live in the engine regardless of the plane:
per-request deadlines with BE load-shedding, submit backpressure
(``max_queue`` → ``rejected``), and the ``grow_deadlock`` youngest-BE shed
that replaces the silent stall when growth exhausts victims.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional

import numpy as np

#: Known fault kinds, by injection site.
FAULT_KINDS = (
    "bw_degrade",        # sim: HBM bandwidth * magnitude for the window
    "thermal_throttle",  # sim: peak FLOPs * magnitude for the window
    "straggler",         # sim: target tenant's kernels / magnitude
    "link_stall",        # PCIe CFS: no fetch starts inside the window
    "swap_write_fail",   # HostSwapPool.put raises HostTierFault
    "swap_read_fail",    # HostSwapPool.get raises HostTierFault
    "page_corrupt",      # point: stored host page corrupted before get
    "alloc_fail",        # PagedKVCache admission/growth defers
    "ctl_missed_tick",   # engine skips a due control tick
    "ctl_stale_signal",  # decide() sees the previous window's signal
)


class HostTierFault(RuntimeError):
    """A host-tier swap operation failed (transient write/read fault)."""

    def __init__(self, kind: str, key=None):
        super().__init__(f"{kind}" + (f" key={key!r}" if key is not None
                                      else ""))
        self.kind = kind
        self.key = key


class ColdPageCorrupt(HostTierFault):
    """A cold page failed its CRC32 checksum at fault-back time."""

    def __init__(self, key=None):
        super().__init__("page_corrupt", key)


@dataclass(frozen=True)
class FaultEvent:
    """One scripted fault: a window ``[t, t + duration)`` (``duration=0`` =
    a point event), optionally scoped to one ``target`` (tenant name).
    ``magnitude`` is the kind-specific severity: a bandwidth/FLOPs scale
    factor in (0, 1] for degradation windows, a slowdown divisor for
    stragglers; ignored by boolean faults."""
    t: float
    kind: str
    duration: float = 0.0
    magnitude: float = 1.0
    target: Optional[str] = None

    @property
    def end(self) -> float:
        return self.t + self.duration


class FaultPlane:
    """Deterministic fault injector (module docstring).

    Queries never consult a clock of their own — the caller passes its
    (virtual or simulated) time ``t``, which is what makes two identical
    runs produce identical ``log`` streams. Window events match while
    ``e.t <= t < e.end``; point events fire once at the first query with
    ``t >= e.t`` and are then consumed.
    """

    def __init__(self, events: Iterable[FaultEvent] = (), *, seed: int = 0):
        evs = sorted(events, key=lambda e: (e.t, e.kind, e.target or ""))
        for e in evs:
            assert e.kind in FAULT_KINDS, f"unknown fault kind {e.kind!r}"
        self.events: List[FaultEvent] = evs
        self.seed = seed
        #: observation-ordered record of every injection actually seen
        self.log: List[dict] = []
        self._seen: set = set()          # event ids already logged
        self._consumed: set = set()      # point-event ids already fired
        self._counts: Dict[str, int] = {}
        #: optional obs.Tracer; injections emit kind="fault" instants at
        #: observation time (same determinism contract as ``log``)
        self.tracer = None

    # -- scenario construction -----------------------------------------
    @classmethod
    def storm(cls, *, horizon: float, seed: int = 0,
              rates: Optional[Dict[str, float]] = None,
              duration: float = 1.0, magnitude: float = 0.5,
              targets: Optional[Dict[str, str]] = None) -> "FaultPlane":
        """Seeded Poisson fault storm: for each kind in ``rates`` (events
        per unit time), draw exponential inter-arrival times over
        ``[0, horizon)``. Same seed → same schedule, independent of query
        order (each kind draws from its own child generator)."""
        rates = rates or {}
        targets = targets or {}
        events: List[FaultEvent] = []
        for i, kind in enumerate(FAULT_KINDS):
            rate = rates.get(kind, 0.0)
            if rate <= 0:
                continue
            rng = np.random.default_rng([seed, i])
            t = 0.0
            while True:
                t += float(rng.exponential(1.0 / rate))
                if t >= horizon:
                    break
                events.append(FaultEvent(t, kind, duration=duration
                                         if kind != "page_corrupt" else 0.0,
                                         magnitude=magnitude,
                                         target=targets.get(kind)))
        return cls(events, seed=seed)

    # -- bookkeeping ----------------------------------------------------
    def _observe(self, e: FaultEvent, t: float):
        if id(e) not in self._seen:
            self._seen.add(id(e))
            self._counts[e.kind] = self._counts.get(e.kind, 0) + 1
            self.log.append({"t_obs": float(t), "t": e.t, "kind": e.kind,
                             "duration": e.duration,
                             "magnitude": e.magnitude, "target": e.target})
            if self.tracer is not None:
                self.tracer.instant(
                    "fault", e.kind, float(t), "faults",
                    target=e.target, magnitude=e.magnitude,
                    duration=e.duration, t_sched=e.t)

    def counts(self) -> Dict[str, int]:
        """Injections actually observed so far, by kind (a scripted event
        nobody ever queried does not count as injected)."""
        return dict(self._counts)

    # -- queries ---------------------------------------------------------
    def active(self, kind: str, t: float, target: Optional[str] = None
               ) -> Optional[FaultEvent]:
        """The first window event of ``kind`` covering ``t`` (and matching
        ``target``, when the event is scoped), else None."""
        for e in self.events:
            if e.t > t:
                break
            if (e.kind == kind and e.duration > 0 and t < e.end
                    and (e.target is None or e.target == target)):
                self._observe(e, t)
                return e
        return None

    def fires(self, kind: str, t: float, target: Optional[str] = None
              ) -> bool:
        """Consume the earliest unconsumed point event of ``kind`` with
        ``e.t <= t`` (matching ``target`` when scoped). One event fires at
        most once."""
        for e in self.events:
            if e.t > t:
                break
            if (e.kind == kind and e.duration == 0
                    and id(e) not in self._consumed
                    and (e.target is None or e.target == target)):
                self._consumed.add(id(e))
                self._observe(e, t)
                return True
        return False

    # -- derived rate scales (simulator seams) ---------------------------
    def bw_scale(self, t: float) -> float:
        """Product of active ``bw_degrade`` magnitudes at ``t`` (1.0 when
        healthy)."""
        s = 1.0
        for e in self.events:
            if e.t > t:
                break
            if e.kind == "bw_degrade" and e.duration > 0 and t < e.end:
                self._observe(e, t)
                s *= max(min(e.magnitude, 1.0), 1e-3)
        return s

    def flops_scale(self, t: float) -> float:
        """Product of active ``thermal_throttle`` magnitudes at ``t``."""
        s = 1.0
        for e in self.events:
            if e.t > t:
                break
            if e.kind == "thermal_throttle" and e.duration > 0 and t < e.end:
                self._observe(e, t)
                s *= max(min(e.magnitude, 1.0), 1e-3)
        return s

    def straggler_slowdown(self, t: float, tenant: str) -> float:
        """Duration multiplier (>= 1) for ``tenant``'s kernels at ``t``:
        1 / magnitude per active straggler event scoped to it (or
        unscoped)."""
        s = 1.0
        for e in self.events:
            if e.t > t:
                break
            if (e.kind == "straggler" and e.duration > 0 and t < e.end
                    and (e.target is None or e.target == tenant)):
                self._observe(e, t)
                s /= max(min(e.magnitude, 1.0), 1e-3)
        return s

    def stall_until(self, t: float) -> float:
        """End of the latest ``link_stall`` window covering ``t`` (``t``
        itself when the link is up) — the PCIe CFS defers fetch quanta to
        this boundary."""
        out = t
        for e in self.events:
            if e.t > t:
                break
            if e.kind == "link_stall" and e.duration > 0 and t < e.end:
                self._observe(e, t)
                out = max(out, e.end)
        return out

    def next_boundary(self, t: float) -> float:
        """Earliest window edge (start or end) strictly after ``t`` —
        simulators cap their event steps here so a rate segment never
        spans a fault transition."""
        nxt = float("inf")
        for e in self.events:
            if e.duration <= 0:
                continue
            if e.t > t:
                nxt = min(nxt, e.t)
                break               # events are start-sorted
            if e.end > t:
                nxt = min(nxt, e.end)
        return nxt


def safe_floor(plan, *, sm_be: float = 0.1, ch_be: float = 1 / 6,
               prefill_budget: Optional[int] = 8):
    """Conservative floor of an existing plan — the watchdog's snap-to
    target when no frontier is available: BE quantum share and channel
    split clamped down, BE prefill throttled."""
    from dataclasses import replace
    return replace(plan, sm_be=min(plan.sm_be, sm_be),
                   ch_be=min(plan.ch_be, ch_be),
                   prefill_budget=(prefill_budget
                                   if plan.prefill_budget is None
                                   else min(plan.prefill_budget,
                                            prefill_budget)))
