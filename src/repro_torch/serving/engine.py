"""Continuous-batching multi-tenant serving engine on PyTorch/CUDA: the
``repro.serving.engine.ServingEngine`` with its two backends, real execution
on a torch device (``backend="torch"``) and the contention simulator
(``backend="sim"``), behind one API.

Each tenant owns a fixed pool of decode slots; requests carry the phase
state machine of :mod:`.scheduler` (``WAITING -> PREFILLING(pos) ->
DECODING -> FINISHED``) and every quantum is composed by the
:class:`~.scheduler.TokenBudgetScheduler`: one batched decode across the
tenant's DECODING slots, then admission, then cached-context prefill chunks
of at most ``chunk_size`` tokens per request, all bounded by the class's
per-quantum token budget. Chunks run through one batched
``prefill_step`` call per chunk-length group; the final prompt position is
always its own one-token chunk, so generated tokens are equal across chunk
sizes.

Models that are not ``tf.chunkable`` (the SSM and hybrid families, whose
recurrent state must step token by token) take the monolithic fallback
instead: each quantum's admitted prompts run whole through one
``tf.prefill`` call per prompt-length group, and the rows of that fresh
cache are scattered into the slot cache. Such models keep dense per-slot
caches (``paged=True`` raises for them).

``paged=True`` keeps the KV cache in a :class:`~.kv_cache.PagedKVCache`
page pool (page-table admission); ``use_flash=True`` routes the attention
core through the CUDA flash-decode / chunked-prefill kernels. LS and BE
tenants share the device by quanta: ``plan.sm_be`` is the fraction of
contended quanta BE receives (with no plan BE is strictly preempted), and
``plan.prefill_budget`` caps BE prefill tokens per quantum.
``preempt_tile`` splits BE prefill chunks into tiles with a preemption
point after each executed wave (an LS arrival aborts the rest of the BE
quantum and is admitted in the same quantum).

``coloring=True`` carves every tenant's KV from a
:class:`~..core.coloring.allocator.ColoredArena` over ``hash_model``'s
channels, split LS/BE by ``ch_be`` (paged mode: one arena group per
request's page group, so admission is bounded by the class's colored
bytes; dense mode: one group per tenant, which caps its slot pool).

**Online control plane**: pass ``controller=`` (an
:class:`~..core.controller.OnlineController` over a plan frontier, or a
:class:`~..core.controller.PlanSchedule`) and the plan becomes
time-varying. Every ``control_interval`` quanta the engine builds a
:class:`~..core.compute.LoadSignal` from LS queue depth, slot occupancy and
the window's SLO attainment, TTFT and TBT p99s, and adopts the controller's
plan at the step boundary via :meth:`ServingEngine.apply_plan`: a new
``sm_be`` takes effect at the next quantum pick, a new ``prefill_budget``
at the next BE prefill, and a ``ch_be`` move resplits the arena and
recolors every KV page pool. LS work arriving under the full-lending plan
triggers an out-of-band tick, so the snap-back waits at most one quantum.
``chunk_governor=`` (a :class:`~..core.controller.ChunkGovernor`) rides
the same tick and retunes ``chunk_size`` and the BE prefill budget from
the window's LS TBT p99. ``transitions`` records every adopted plan with
the pages migrated. The resplit is placement bookkeeping: device pools and
page tables never move, so a mid-run plan change never alters tokens.

**KV memory hierarchy** (``paged=True`` only). ``prefix_cache=True`` gives
each tenant a :class:`~.prefix_cache.PrefixCache`: a radix tree over prompt
token ids whose nodes own ref-counted KV pages. Admission maps the cached
prefix pages copy-on-write into the slot's page table and prefills only the
uncached suffix (the paged chunked-prefill kernel starts at ``pos`` = the
hit length, over the shared pages); a chunk or decode write into a shared
page forks it first. Committed prompt pages are donated to the tree at the
first token, the rest at eviction; zero-ref leaves are LRU-evicted under
pool pressure, and shared pages a live page table references are pinned
out of tidal resplits. ``grow_pages=True`` admits on the prompt's pages
only and maps each decode page at its boundary crossing; on pool
exhaustion the youngest younger request is preempted (restarted from
scratch) or, with ``swap=True``, its page group is copied to a per-tenant
:class:`~.swap.HostSwapPool` (``cold_dtype`` "fp16": the pool's own bits;
"int8": per-page abs-max) and faulted back, ``swap_quantum_pages`` a
quantum, when it re-admits. With a prefix cache the host pool is also the
tree's cold tier: evicted leaves' pages survive there and re-adopt before
a matching admission.

**Fault plane** (``faults=``, a :class:`~.faults.FaultPlane`): seeded
injections at the host tier (write and read windows, page corruption
caught by a CRC32), the allocator (``alloc_fail`` defers admission and
growth), and the control tick (``ctl_missed_tick``, ``ctl_stale_signal``).
``fault_recovery`` switches the recovery paths on: swap-in retry with
backoff, preempt-restart on a write fault or a corrupt page, deadline
shedding (``submit(deadline=)``), grow-deadlock shedding, and the
controller watchdog that snaps to a safe plan when LS starves. Every
recovery is charged to the tenant; each ``fault_budget`` points take the
next rung of its ladder: ``flash_to_dense`` (its forwards rebuilt on the
torch-op attention core), ``swap_to_preempt``, ``grow_to_full``.

**Disaggregation seams** (:mod:`.disagg`): ``chunk_hook(rt, req)`` fires
after each mid-prompt chunk commits (the prefill slice streams the pages it
completed); ``migrate_hook(rt, req)`` fires when a still-live request's
prompt completes and returns True to take it (the slot's pages are freed
without a second donation and the request leaves this engine).

**Simulator backend** (``backend="sim"``): the same ``submit`` stream drives
the discrete-event contention simulator (:mod:`..core.simulator`) on the
``device`` model under the compute ``policy``: each tenant's kernels are
derived from its requests (prompt-sized prefill, chunked when
``chunk_size`` is set, per-step decode whose KV-write term follows
``paged``, the prefix-cache estimate, ``sim_swap_bytes``), and
``run_until_idle(horizon=)`` writes the modeled completions back. It
creates no tensor and compiles no kernel.

PyTorch runs eagerly, so there is no compile step; pools and dense caches
are updated in place. The torch backend serves every decoder-only family
(GQA, MLA, MoE, SSM, hybrid); encoder and vision models are refused at
:meth:`ServingEngine.add_tenant`, since a request carries tokens only (the
reference's engine fails on them at their first prefill). They run through
the model API.
"""
from __future__ import annotations

import time
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.coloring.allocator import (ColoredArena, OutOfColoredMemory,
                                       split_channels)
from ..core.compute import ComputePolicy, LoadSignal
from ..core.controller import ResourcePlan, measured_prefix_hit
from ..core.simulator import (GPU_DEVICES, GPUSimulator, Kernel, Tenant,
                              request_kernels)
from ..core.tenancy import TenantSpec
from ..models import transformer as tf
from ..models.common import dt
from .. import obs
from .faults import ColdPageCorrupt, FaultPlane, HostTierFault, safe_floor
from .kv_cache import PagedKVCache, kv_bytes_per_token
from .prefix_cache import PrefixCache
from .scheduler import (Phase, QuantumReport, TokenBudgetScheduler,
                        split_tiles)
from .swap import HostSwapPool


def resolve_device(torch_device) -> torch.device:
    """The engine's device: CUDA unless the caller asks for the CPU. A CUDA
    request on a host without CUDA raises; it never falls back."""
    dev = torch.device(torch_device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("torch_device=cuda but no CUDA device is present; "
                           "pass torch_device='cpu' to run on the CPU")
    return dev


@dataclass
class Request:
    rid: int
    tenant: str
    tokens: np.ndarray             # [S] prompt
    max_new: int
    t_submit: float
    t_admit: Optional[float] = None   # entered a decode slot
    t_first: Optional[float] = None   # first output token (TTFT)
    t_last: Optional[float] = None    # latest output token (TBT tracking)
    t_done: Optional[float] = None
    output: Optional[list] = None
    slot: Optional[int] = None
    failed: bool = False           # rejected (e.g. can never fit KV pages)
    hit_tokens: int = 0            # prefix-cache hit length at admission
    # phase state machine (serving.scheduler); ``prefill_pos`` is the next
    # prompt position to compute (a prefix-cache hit starts at its uncached
    # suffix)
    phase: Phase = Phase.WAITING
    prefill_pos: int = 0
    # KV-hierarchy state: a preempted request restarts from scratch; a
    # swapped-out decode keeps its host page keys plus the decode state to
    # resume from once the pages fault back in (SWAPPED -> SWAPPING)
    swap_keys: Optional[list] = None   # host-tier keys, logical page order
    swap_cursor: int = 0               # next page to fault in
    resume_pos: int = 0                # rt.pos at swap-out
    resume_tok: int = 0                # rt.last_tok at swap-out
    t_evicted: Optional[float] = None  # set at preempt/swap-out, cleared at
    preempts: int = 0                  # the resume token (warm-restart gap)
    # fault-plane state: deadline is absolute (clock units); rejected marks
    # submit backpressure; shed marks a request dropped by a recovery path
    # (deadline, grow deadlock); swap_retries / swap_backoff drive the
    # bounded retry with backoff of swap-in faults (backoff = engine step
    # index before which no retry is attempted)
    deadline: Optional[float] = None
    rejected: bool = False
    shed: bool = False
    swap_retries: int = 0
    swap_backoff: int = 0

    @property
    def latency(self):
        return None if self.t_done is None else self.t_done - self.t_submit

    @property
    def ttft(self):
        return None if self.t_first is None else self.t_first - self.t_submit


@dataclass
class _TenantRT:
    spec: TenantSpec
    cfg: ModelConfig
    params: object
    n_slots: int
    decode_fn: object = None
    chunk_fn: object = None                 # cached-context prefill chunk
    queue: List[Request] = field(default_factory=list)
    done: List[Request] = field(default_factory=list)
    cache: object = None
    pos: Optional[np.ndarray] = None        # [n_slots] next write position
    last_tok: Optional[np.ndarray] = None   # [n_slots] last emitted token
    active: List[Optional[Request]] = field(default_factory=list)
    alloc_name: Optional[str] = None        # dense-mode arena group
    kv: Optional[PagedKVCache] = None       # page-table state (paged mode)
    prefix: Optional[PrefixCache] = None    # radix-tree page sharing
    peak_active: int = 0                    # max concurrent decode slots seen
    prefill_tokens: int = 0                 # prompt tokens admitted
    prefill_computed: int = 0               # prompt tokens actually prefilled
    tbt_gaps: List[float] = field(default_factory=list)  # inter-token gaps
    # KV-hierarchy state (swap mode)
    host: Optional[HostSwapPool] = None     # host tier for swapped pages
    preemptions: int = 0                    # requests restarted from scratch
    swap_outs: int = 0                      # decode page groups pushed to host
    swap_ins: int = 0                       # page groups faulted back
    grow_stalls: int = 0                    # decode quanta stalled on growth
    chunk_aborts: int = 0                   # sub-chunk prefill preemptions
    resume_gaps: List[float] = field(default_factory=list)  # evict->token
    # fault-plane state: counters for the recovery paths plus the
    # per-tenant degradation ladder — every recovery costs one point of
    # fault_score; each fault_budget points takes the next rung
    rejected: int = 0                       # submit backpressure rejections
    shed: int = 0                           # requests load-shed by recovery
    grow_deadlocks: int = 0                 # growth exhausted all victims
    deadlock_streak: int = 0                # consecutive victimless stalls
    swap_retries: int = 0                   # swap-in fault retries
    fault_recoveries: Dict[str, int] = field(default_factory=dict)
    fault_score: int = 0
    degraded: List[str] = field(default_factory=list)  # ladder rungs taken
    flash: bool = False                     # current attention path
    swap_degraded: bool = False             # rung: swap-out -> preempt
    grow_degraded: bool = False             # rung: growth -> full extent
    # sim-backend knobs / results
    closed_loop: bool = False
    sim_seq: Optional[int] = None
    max_kernels: int = 24
    sim_completed: int = 0
    sim_swap_bytes: int = 0                 # modeled swap traffic per request

    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.active)


def _scatter_rows(dst_cache, src_cache, slots):
    """Write the rows of a freshly prefilled cache into the slot cache, in
    place. ``layers`` leaves are [n_periods, B, ...] (batch axis 1);
    ``prefix`` entries are per-layer dicts with batch axis 0."""
    for dp, sp in zip(dst_cache.get("prefix", []),
                      src_cache.get("prefix", [])):
        for name, d in dp.items():
            d[slots] = sp[name].to(d.dtype)

    def layers(d, s):
        if isinstance(d, dict):
            for name in d:
                layers(d[name], s[name])
        else:
            d[:, slots] = s.to(d.dtype)
    layers(dst_cache["layers"], src_cache["layers"])


def _earliest_outstanding(rt: "_TenantRT") -> float:
    """Tenant-priority key for ``ServingEngine._pick``: earliest submit
    time among this tenant's queued + active requests."""
    ts = [r.t_submit for r in rt.queue]
    ts += [r.t_submit for r in rt.active if r is not None]
    return min(ts) if ts else float("inf")


class _TorchBackend:
    """Slot-pool continuous batching on the engine's torch device."""

    def __init__(self, engine: "ServingEngine"):
        self.engine = engine

    def _build_fns(self, rt: _TenantRT):
        """(Re)build the tenant's batched decode and prefill-chunk forwards.
        The attention path is taken from ``rt.flash`` by value, so the
        degradation ladder's flash->dense rung can rebuild one live tenant
        mid-run without touching any other tenant or the engine-wide
        default."""
        cfg = rt.cfg
        flash = rt.flash

        def _decode(p, tok, cache, pos, pt=None):
            return tf.decode_step(p, cfg, tok, cache, pos,
                                  ctx_extra=({"page_table": pt}
                                             if pt is not None else None),
                                  use_flash=flash)

        def _chunk(p, toks, cache, pos, pt=None):
            return tf.prefill_step(p, cfg, toks, cache, pos,
                                   ctx_extra=({"page_table": pt}
                                              if pt is not None else None),
                                   use_flash=flash)

        rt.decode_fn = _decode
        # monolithic prompt processing (``_prefill_monolithic``) serves the
        # models the cached-context chunk path cannot (SSM state)
        rt.chunk_fn = _chunk if tf.chunkable(cfg) else None

    def add_tenant(self, rt: _TenantRT):
        eng = self.engine
        rt.flash = eng.use_flash
        self._build_fns(rt)
        if eng.paged:
            chans = cap = None
            if eng.arena is not None:
                chans = eng.ls_ch if rt.spec.is_ls else eng.be_ch
                if eng.controller is not None:
                    # tidal pools: size the device pool for the lending
                    # maximum (every channel); live admission still runs
                    # against the class's current colored bytes
                    cap = tuple(range(eng.arena.num_channels))
            rt.kv = PagedKVCache(rt.cfg, rt.n_slots, eng.max_seq,
                                 eng.page_size, n_pages=eng.kv_pages,
                                 arena=eng.arena, channels=chans,
                                 name=rt.spec.name, cap_channels=cap,
                                 sharing=eng.prefix_cache,
                                 device=eng.torch_device)
            if eng.faults is not None:
                # allocation faults defer admission/growth at the call
                # sites, never inside can_admit_pages (kv_cache)
                rt.kv.fault_hook = (
                    lambda _rt=rt: eng.faults.active(
                        "alloc_fail", eng.clock(),
                        target=_rt.spec.name) is not None)
            if eng.prefix_cache:
                rt.prefix = PrefixCache(eng.page_size, rt.kv)
            rt.cache = rt.kv.init_pools()
            if eng.swap:
                rt.host = HostSwapPool(eng.cold_dtype,
                                       tenant=rt.spec.name,
                                       priority=rt.spec.priority,
                                       nice=rt.spec.nice,
                                       faults=eng.faults,
                                       verify=eng.fault_recovery)
                if eng.tracer.level >= 0:
                    rt.host.tracer = eng.tracer
                    rt.host.trace_prefix = eng._trace_prefix
                if rt.prefix is not None:
                    # cold prefix tier: evicted leaves' pages survive on the
                    # host and fault back in before a matching admission
                    def _store(key, page, _rt=rt):
                        _rt.host.drop(key)   # re-evicted after a re-donate
                        _rt.host.put(_rt.cache, key, page, t=eng.clock())

                    def _load(key, page, _rt=rt):
                        _rt.host.get(_rt.cache, key, page, t=eng.clock())

                    rt.prefix.cold_store = _store
                    rt.prefix.cold_loader = _load
                    rt.prefix.cold_has = lambda key, _rt=rt: key in _rt.host
        else:
            rt.cache = tf.init_cache(rt.cfg, rt.n_slots, eng.max_seq,
                                     device=eng.torch_device)
        rt.pos = np.zeros(rt.n_slots, np.int32)
        rt.last_tok = np.zeros(rt.n_slots, np.int32)
        rt.active = [None] * rt.n_slots

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            self.engine.torch_device)

    # -- step-boundary eviction ------------------------------------------
    def _finish(self, rt: _TenantRT, slot: int):
        req = rt.active[slot]
        eng = self.engine
        eng._trace_leave(rt, req, slot, req.phase.name.lower(), "finished")
        req.t_done = eng.clock()
        req.phase = Phase.FINISHED
        rt.done.append(req)
        eng._trace_done(rt, req)
        rt.active[slot] = None
        pos = int(rt.pos[slot])
        rt.pos[slot] = 0
        rt.last_tok[slot] = 0
        if rt.prefix is not None:
            # KV token stream: prompt, then the fed-back outputs (the last
            # output token's KV was never written) — donate full pages to
            # the radix tree, then release the slot's private pages
            stream = np.concatenate(
                [req.tokens,
                 np.asarray(req.output[:max(pos - len(req.tokens), 0)],
                            np.int32)])
            rt.prefix.release_slot(slot, stream, pos)
        elif rt.kv is not None:
            rt.kv.free_slot(slot)

    # -- KV hierarchy: growth / preemption / swap ----------------------
    def _drop_slot_pages(self, rt: _TenantRT, slot: int):
        """Free a slot's pages *without* donating to the prefix tree (the
        preempt/swap-out path: the content either restarts from scratch or
        already lives on the host)."""
        if rt.prefix is not None:
            rt.prefix.release_slot(slot, None, 0)
        elif rt.kv is not None:
            rt.kv.free_slot(slot)

    # -- fault plane: recovery bookkeeping / degradation ladder ---------
    def _record_recovery(self, rt: _TenantRT, kind: str):
        """Charge a recovery action against the tenant's fault budget.
        Every ``fault_budget`` points the degradation ladder takes its next
        rung (the faults module docstring): flash->dense attention (the
        CUDA kernels -> the torch-op core), swap-out->preempt-restart,
        page-growth->full-extent admission — each trades peak efficiency
        for fewer moving parts under a storm."""
        rt.fault_recoveries[kind] = rt.fault_recoveries.get(kind, 0) + 1
        rt.fault_score += 1
        eng = self.engine
        eng.tracer.instant("recovery", kind, eng.clock(),
                           f"{eng._trace_prefix}recovery",
                           tenant=rt.spec.name, score=rt.fault_score)
        while rt.fault_score >= eng.fault_budget * (len(rt.degraded) + 1):
            if rt.flash:
                rt.flash = False
                self._build_fns(rt)
                rt.degraded.append("flash_to_dense")
            elif eng.swap and not rt.swap_degraded:
                rt.swap_degraded = True
                rt.degraded.append("swap_to_preempt")
            elif eng.grow_pages and not rt.grow_degraded:
                rt.grow_degraded = True
                rt.degraded.append("grow_to_full")
            else:
                break

    def _shed(self, rt: _TenantRT, req: Request, reason: str):
        """Load-shed a request (deadline expiry, grow deadlock): device
        pages freed without donation, host-tier pages dropped, and the
        request finishes failed+shed — recovery trades one BE request for
        the batch's forward progress instead of stalling everyone."""
        eng = self.engine
        eng.tracer.instant("recovery", reason, eng.clock(),
                           f"{eng._trace_prefix}recovery",
                           tenant=rt.spec.name, rid=req.rid)
        if req.slot is not None:
            s = req.slot
            eng._trace_leave(rt, req, s, req.phase.name.lower(), reason)
            self._drop_slot_pages(rt, s)
            rt.active[s] = None
            rt.pos[s] = 0
            rt.last_tok[s] = 0
            req.slot = None
        elif req in rt.queue:
            rt.queue.remove(req)
        if req.swap_keys and rt.host is not None:
            for k in req.swap_keys:
                rt.host.drop(k)
        req.swap_keys = None
        req.failed = True
        req.shed = True
        req.phase = Phase.FINISHED
        req.t_done = self.engine.clock()
        if req.output is None:
            req.output = []
        rt.shed += 1
        rt.done.append(req)
        eng._trace_done(rt, req)

    def _youngest_victim(self, rt: _TenantRT, exclude: int,
                         younger_than: Optional[Request] = None
                         ) -> Optional[Request]:
        """Preemption victim under pool exhaustion: the youngest (latest
        submit) other active request in this tenant's pool — least sunk
        work, and it re-queues behind everything it raced. The growing slot
        itself is excluded (self-preemption would livelock), and with
        ``younger_than`` only requests strictly younger than the grower
        qualify: under preempt-restart two peers stealing each other's
        pages would otherwise reset each other's output forever —
        seniority makes the eldest's progress monotone, which is what
        guarantees the pool eventually drains."""
        age = (lambda r: (r.t_submit, r.rid))
        cands = [r for s, r in enumerate(rt.active)
                 if r is not None and s != exclude
                 and r.phase in (Phase.PREFILLING, Phase.DECODING)
                 and (younger_than is None or age(r) > age(younger_than))]
        if not cands:
            return None
        return max(cands, key=age)

    def _preempt(self, rt: _TenantRT, req: Request):
        """Restart a victim from scratch (swap off, or a mid-prefill victim
        with no resumable decode state): pages freed without donation, phase
        back to WAITING, re-queued. Deterministic greedy decode makes the
        restart emit identical tokens."""
        s = req.slot
        self.engine._trace_leave(rt, req, s, req.phase.name.lower(),
                                 "preempt")
        self._drop_slot_pages(rt, s)
        rt.active[s] = None
        rt.pos[s] = 0
        rt.last_tok[s] = 0
        req.t_evicted = self.engine.clock()
        req.phase = Phase.WAITING
        req.slot = None
        req.prefill_pos = 0
        req.output = None
        req.t_first = req.t_last = req.t_admit = None
        req.hit_tokens = 0
        req.swap_keys = None
        req.preempts += 1
        rt.preemptions += 1
        rt.queue.append(req)

    def _swap_out(self, rt: _TenantRT, req: Request) -> int:
        """Move a decoding victim's whole page group to the host tier:
        page contents copied in logical order (quantized per ``cold_dtype``),
        decode resume state saved, device pages freed without donation, the
        request re-queued as SWAPPED. Returns pages moved."""
        eng = self.engine
        s, kv = req.slot, rt.kv
        n = kv.mapped_count(s)
        now = eng.clock()
        keys = []
        try:
            for j in range(n):
                key = ("req", req.rid, j)
                rt.host.drop(key)
                rt.host.put(rt.cache, key, int(kv.page_table[s, j]), t=now)
                keys.append(key)
        except HostTierFault:
            # mid-group write fault: the host must never hold a partial
            # page group — drop what landed, let the caller pick a fallback
            for k in keys:
                rt.host.drop(k)
            raise
        req.swap_keys = keys
        req.swap_cursor = 0
        req.resume_pos = int(rt.pos[s])
        req.resume_tok = int(rt.last_tok[s])
        if req.t_evicted is not None:
            # re-evicted before decoding a token after its last swap-in:
            # close the pending warm-restart gap here so every completed
            # swap-in records exactly one resume gap
            rt.resume_gaps.append(now - req.t_evicted)
        req.t_evicted = now
        eng._trace_leave(rt, req, s, req.phase.name.lower(), "swap_out")
        req.phase = Phase.SWAPPED
        req.slot = None
        self._drop_slot_pages(rt, s)
        rt.active[s] = None
        rt.pos[s] = 0
        rt.last_tok[s] = 0
        rt.swap_outs += 1
        rt.queue.append(req)
        return n

    def _ensure_growth(self, rt: _TenantRT, slots: List[int]):
        """Growth pre-pass before the decode batch: map the page each
        decode write needs (growth-mode admission only reserved the
        prompt's pages). On pool exhaustion: free cold prefix leaves first,
        then swap out — or, with swap off / for a mid-prefill victim,
        preempt — the youngest other active request; a slot that still
        can't grow stalls out of this quantum's decode batch. Under the
        fault plane: an ``alloc_fail`` window defers every growth (no
        eviction), a swap write fault downgrades that victim to a preempt,
        and a *persistent* no-victim deadlock (``deadlock_patience``
        quanta) sheds the youngest BE request rather than spinning.
        Victims must be strictly younger than their grower, so the eldest
        request's progress is monotone — the liveness argument for the
        preempt-restart path. Returns (ready slots, pages swapped out)."""
        eng = self.engine
        kv = rt.kv
        ready, out_pages = [], 0
        if kv.alloc_fault():
            # allocator fault window: defer every growth this quantum —
            # nothing is evicted, the growers stall, and slots that already
            # own their next page decode normally
            for s in slots:
                req = rt.active[s]
                if req is None or req.phase is not Phase.DECODING:
                    continue
                if kv.needs_grow(s, int(rt.pos[s])):
                    rt.grow_stalls += 1
                else:
                    ready.append(s)
            return ready, 0
        for s in slots:
            req = rt.active[s]
            if req is None or req.phase is not Phase.DECODING:
                continue          # taken as a victim by an earlier grower
            if not kv.needs_grow(s, int(rt.pos[s])):
                ready.append(s)
                continue
            grown = False
            while True:
                if kv.can_admit_pages(1):
                    kv.grow_slot(s)
                    grown = True
                    rt.deadlock_streak = 0
                    break
                if rt.prefix is not None and rt.prefix.evict_until(1):
                    continue
                victim = self._youngest_victim(rt, exclude=s,
                                               younger_than=req)
                if victim is None:
                    if self._youngest_victim(rt, exclude=s) is not None:
                        # only elders are killable: stall — seniority says
                        # the eldest grower wins, and its monotone progress
                        # is what drains the pool for this slot later
                        break
                    # every other slot is SWAPPING/unkillable; one
                    # victimless quantum is usually just a swap-in
                    # mid-flight, so only a *persistent* streak
                    # (deadlock_patience quanta) counts as a deadlock; then
                    # BE under recovery sheds the youngest active request
                    # of any phase — including the grower itself — so the
                    # pool drains. LS stalls and surfaces via the counter
                    # instead of losing work.
                    rt.deadlock_streak += 1
                    if rt.deadlock_streak >= eng.deadlock_patience:
                        rt.deadlock_streak = 0
                        rt.grow_deadlocks += 1
                        if not rt.spec.is_ls and eng.fault_recovery:
                            cands = [r for r in rt.active if r is not None]
                            if cands:
                                shed = max(cands,
                                           key=lambda r: (r.t_submit, r.rid))
                                self._shed(rt, shed, "grow_deadlock")
                                if shed is not req:
                                    continue
                    break
                if (rt.host is not None and not rt.swap_degraded
                        and victim.phase is Phase.DECODING):
                    try:
                        out_pages += self._swap_out(rt, victim)
                    except HostTierFault:
                        # host write window: fall back one rung for this
                        # victim — preempt-restart instead of stalling
                        if eng.fault_recovery:
                            self._record_recovery(rt, "swap_write")
                            self._preempt(rt, victim)
                        else:
                            break
                else:
                    self._preempt(rt, victim)
            if grown:
                ready.append(s)
            elif rt.active[s] is not None:
                rt.grow_stalls += 1
        return ([s for s in ready if rt.active[s] is not None
                 and rt.active[s].phase is Phase.DECODING], out_pages)

    def _swap_progress(self, rt: _TenantRT) -> int:
        """Fault host pages back into SWAPPING slots, up to the engine's
        ``swap_quantum_pages`` per quantum — the SWAPPING phase is paced
        across quanta so decode keeps ticking next to a fault storm. A
        slot whose page group completes resumes DECODING where it left
        off (pos + last token restored)."""
        eng = self.engine
        budget = eng.swap_quantum_pages
        pages = 0
        for s in eng.scheduler.swap_slots(rt):
            if budget <= 0:
                break
            req = rt.active[s]
            if req.swap_backoff > eng._step_idx:
                continue          # backing off a faulted swap-in
            faulted = False
            while budget > 0 and req.swap_cursor < len(req.swap_keys):
                dst = int(rt.kv.page_table[s, req.swap_cursor])
                try:
                    rt.host.get(rt.cache, req.swap_keys[req.swap_cursor],
                                dst, t=eng.clock())
                except HostTierFault as e:
                    faulted = True
                    if not eng.fault_recovery:
                        break     # naive baseline: blind retry next quantum
                    req.swap_retries += 1
                    rt.swap_retries += 1
                    if (isinstance(e, ColdPageCorrupt)
                            or req.swap_retries > eng.swap_retry_limit):
                        # unrecoverable (corrupt page / retries exhausted):
                        # abandon the host copy and preempt-restart — the
                        # deterministic replay re-emits identical tokens
                        for k in req.swap_keys:
                            rt.host.drop(k)
                        self._record_recovery(rt, "swap_read")
                        self._preempt(rt, req)
                        req.swap_retries = 0
                        req.swap_backoff = 0
                    else:
                        # bounded retry with exponential backoff, in engine
                        # steps — the transient window clears while other
                        # slots keep their swap-in budget
                        req.swap_backoff = eng._step_idx + (
                            1 << min(req.swap_retries, 4))
                    break
                req.swap_cursor += 1
                budget -= 1
                pages += 1
            if faulted:
                continue
            if req.swap_cursor >= len(req.swap_keys):
                rt.pos[s] = req.resume_pos
                rt.last_tok[s] = req.resume_tok
                eng._trace_phase(rt, req, "swapping", "decoding")
                req.phase = Phase.DECODING
                req.swap_keys = None
                req.swap_retries = 0
                req.swap_backoff = 0
                rt.swap_ins += 1
        return pages

    def _write_sentinel(self, rt: _TenantRT) -> int:
        """A cache position no batched call may write: dense caches drop any
        position >= max_seq; paged lookups drop any logical page >= the
        table width. Used to mask rows out of a batched decode/chunk call
        (their compute runs, their writes drop, their outputs are
        ignored)."""
        if rt.kv is not None:
            return rt.kv.pages_per_slot * rt.kv.page_size
        return self.engine.max_seq

    def _seed_first_token(self, rt: _TenantRT, req: Request, first_tok: int):
        """Prefill-completion epilogue: the request enters DECODING seeded
        with its first output token; the committed full prompt pages are
        donated to the prefix tree; degenerate (max_new<=1) requests finish
        immediately."""
        eng = self.engine
        s = req.slot
        L = len(req.tokens)
        now = eng.clock()
        req.t_first = req.t_last = now
        if req.t_evicted is not None:       # preempt-restart warm TTFT
            rt.resume_gaps.append(now - req.t_evicted)
            req.t_evicted = None
        eng._trace_phase(rt, req, req.phase.name.lower(), "decoding")
        req.phase = Phase.DECODING
        req.output = [int(first_tok)]
        rt.pos[s] = L
        rt.last_tok[s] = req.output[0]
        if rt.prefix is not None:
            rt.prefix.donate(s, req.tokens, L)
        if len(req.output) >= max(req.max_new, 1) or rt.pos[s] >= eng.max_seq:
            self._finish(rt, s)
        elif eng.migrate_hook is not None and eng.migrate_hook(rt, req):
            # disaggregated handoff: the decode slice owns the request now;
            # the hook serialized the page group, so only free the slot
            # (the prefix donation above already happened: no second
            # donation, and no local decode step runs for this request)
            eng._trace_leave(rt, req, s, "decoding", "migrated")
            self._drop_slot_pages(rt, s)
            rt.active[s] = None
            rt.pos[s] = 0
            rt.last_tok[s] = 0

    def _prefill_monolithic(self, rt: _TenantRT, reqs: List[Request]) -> int:
        """Prompt processing for non-chunkable models: one batched
        ``tf.prefill`` call per prompt-length group (no flash kernels, as
        in the reference), its rows scattered into the slot cache. Whole
        prompts, one quantum. Returns tokens computed."""
        eng = self.engine
        by_len: Dict[int, List[Request]] = {}
        for r in reqs:
            by_len.setdefault(len(r.tokens), []).append(r)
        tokens = 0
        for L, group in by_len.items():
            toks = self._dev(np.stack([r.tokens for r in group]))
            slots = self._dev(np.asarray([r.slot for r in group], np.int64))
            with torch.inference_mode():
                last_logits, pcache = tf.prefill(rt.params, rt.cfg,
                                                 {"tokens": toks},
                                                 eng.max_seq)
                _scatter_rows(rt.cache, pcache, slots)
            first = last_logits[:, 0].argmax(dim=-1).cpu().numpy()
            rt.prefill_computed += L * len(group)
            tokens += L * len(group)
            for j, req in enumerate(group):
                req.prefill_pos = L
                self._seed_first_token(rt, req, int(first[j]))
        return tokens

    def _run_chunks(self, rt: _TenantRT, chunks) -> int:
        """Execute this quantum's prefill chunks: waves preserve per-slot
        chunk order, each wave batches equal-length chunks into one
        cached-context ``prefill_step`` call across the slot pool (rows not
        in the group sit at the write sentinel — writes drop, logits
        ignored). A chunk write landing in a shared page forks it
        copy-on-write first; a chunk that reaches the end of its prompt
        seeds the request's first output token. Returns tokens computed.

        Sub-chunk preemption (``eng.preempt_tile``): a BE tenant's chunks
        are split into tiles of at most ``preempt_tile`` tokens, and after
        every executed wave, if an LS request is waiting, the remaining
        tiles are aborted (each executed tile already committed its
        ``prefill_pos``) and the waiting LS requests are admitted in this
        quantum. A resumed chunk is just a smaller chunk, so tokens are
        equal under any preemption pattern."""
        eng = self.engine
        kv = rt.kv
        preemptable = bool(eng.preempt_tile) and not rt.spec.is_ls
        if preemptable:
            chunks = split_tiles(chunks, eng.preempt_tile)
        by_slot: Dict[int, list] = {}
        for c in chunks:
            by_slot.setdefault(c.slot, []).append(c)
        tokens = 0
        sentinel = self._write_sentinel(rt)
        while any(by_slot.values()):
            wave = [lst.pop(0) for lst in by_slot.values() if lst]
            wave_tokens = 0
            by_len: Dict[int, list] = {}
            for c in wave:
                by_len.setdefault(c.length, []).append(c)
            for Sq, group in by_len.items():
                toks = np.zeros((rt.n_slots, Sq), np.int32)
                pos = np.full(rt.n_slots, sentinel, np.int32)
                for c in group:
                    toks[c.slot] = c.req.tokens[c.start:c.start + Sq]
                    pos[c.slot] = c.start
                    if kv is not None:
                        # fork every shared page this chunk will write into
                        for pg in range(c.start // kv.page_size,
                                        (c.start + Sq - 1) // kv.page_size
                                        + 1):
                            if kv.needs_fork(c.slot, pg * kv.page_size):
                                kv.fork_cow(rt.cache, c.slot, pg)
                pt = kv.device_page_table() if kv is not None else None
                with torch.inference_mode():
                    logits, rt.cache = rt.chunk_fn(
                        rt.params, self._dev(toks), rt.cache, self._dev(pos),
                        pt)
                rt.prefill_computed += Sq * len(group)
                if eng.tracer.enabled("chunk"):
                    t_c = eng.clock()
                    for c in group:
                        eng.tracer.instant(
                            "chunk", f"c{c.start}", t_c,
                            eng._tr_track(rt, c.slot), rid=c.req.rid,
                            start=c.start, len=Sq)
                if eng._aborted_rids and eng.tracer.enabled("preempt"):
                    t_c = eng.clock()
                    for c in group:
                        if c.req.rid in eng._aborted_rids:
                            eng.tracer.instant(
                                "preempt", "resume", t_c,
                                eng._tr_track(rt, c.slot),
                                tenant=rt.spec.name, rid=c.req.rid,
                                start=c.start)
                for c in group:
                    eng._aborted_rids.discard(c.req.rid)
                tokens += Sq * len(group)
                wave_tokens += Sq * len(group)
                done = [c for c in group
                        if c.start + Sq >= len(c.req.tokens)]
                if done:
                    arg = logits[:, 0].argmax(dim=-1).cpu().numpy()
                hook = eng.chunk_hook
                for c in group:
                    c.req.prefill_pos = c.start + Sq
                    if hook is not None and c.start + Sq < len(c.req.tokens):
                        # mid-prompt commit: stream the newly completed KV
                        # pages while the remaining chunks still run
                        hook(rt, c.req)
                for c in done:
                    self._seed_first_token(rt, c.req, int(arg[c.slot]))
            if eng.arrival_hook is not None:
                eng.arrival_hook(wave_tokens)
            if preemptable and any(by_slot.values()) \
                    and self._preempt_now():
                self._abort_remaining(rt, by_slot)
                break
        return tokens

    def _preempt_now(self) -> bool:
        """Preemption predicate at the tile boundary: an LS request is
        waiting for admission (``preempt_hook`` overrides for tests)."""
        eng = self.engine
        if eng.preempt_hook is not None:
            return bool(eng.preempt_hook())
        return any(rt.spec.is_ls
                   and any(r.phase in (Phase.WAITING, Phase.SWAPPED)
                           for r in rt.queue)
                   for rt in eng.tenants.values())

    def _abort_remaining(self, rt: _TenantRT, by_slot):
        """Abort the quantum's remaining BE tiles and admit waiting LS
        requests in the same quantum."""
        eng = self.engine
        now = eng.clock()
        rt.chunk_aborts += 1
        eng.preempt_aborts += 1
        remaining = [lst[0].req for lst in by_slot.values() if lst]
        for req in remaining:
            eng._aborted_rids.add(req.rid)
        if eng.tracer.enabled("preempt"):
            for req in remaining:
                eng.tracer.instant(
                    "preempt", "abort", now, eng._tr_track(rt, req.slot),
                    tenant=rt.spec.name, rid=req.rid, pos=req.prefill_pos)
        for ls_rt in eng.tenants.values():
            if not ls_rt.spec.is_ls or not ls_rt.queue:
                continue
            for r in eng.scheduler.admit(ls_rt, eng):
                eng.preempt_waits.append(max(now - r.t_submit, 0.0))

    def _decode(self, rt: _TenantRT, slots: List[int]):
        """One batched decode across the tenant's DECODING slots. Rows not
        in ``slots`` (free, or mid-prefill) are masked to the write
        sentinel: their cache writes drop and their outputs are ignored."""
        eng = self.engine
        rt.peak_active = max(rt.peak_active,
                             sum(r is not None for r in rt.active))
        live = np.zeros(rt.n_slots, bool)
        live[slots] = True
        if rt.prefix is not None:
            # safety net: a decode append must never mutate a shared page
            # (admission reserves + chunk execution fork every predicted
            # write, so this does not fire on the predicted paths)
            for s in slots:
                if rt.kv.needs_fork(s, int(rt.pos[s])):
                    rt.kv.fork_cow(rt.cache, s,
                                   int(rt.pos[s]) // rt.kv.page_size)
        dec_pos = np.where(live, rt.pos,
                           self._write_sentinel(rt)).astype(np.int32)
        pt = rt.kv.device_page_table() if rt.kv is not None else None
        with torch.inference_mode():
            logits, rt.cache = rt.decode_fn(
                rt.params, self._dev(rt.last_tok[:, None]), rt.cache,
                self._dev(dec_pos), pt)
        nxt = logits[:, 0].argmax(dim=-1).cpu().numpy()
        now = eng.clock()
        for s in slots:
            req = rt.active[s]
            rt.pos[s] += 1
            tok = int(nxt[s])
            req.output.append(tok)
            rt.last_tok[s] = tok
            if req.t_last is not None:
                rt.tbt_gaps.append(now - req.t_last)
                if rt.spec.is_ls:
                    eng.registry.histogram("ls_tbt_all_ms").record(
                        (now - req.t_last) * 1e3)
            req.t_last = now
            if req.t_evicted is not None:   # first token after a swap-in
                rt.resume_gaps.append(now - req.t_evicted)
                req.t_evicted = None
            if len(req.output) >= max(req.max_new, 1) \
                    or rt.pos[s] >= eng.max_seq:
                self._finish(rt, s)

    def quantum(self, rt: _TenantRT) -> bool:
        """One scheduler-composed quantum: decode first (a request finishing
        here releases its KV pages before this quantum's admission pass),
        with growth pages mapped before it; then admission (slots + pages
        only), then swap-in progress, then prefill chunks under the class
        token budget. Under recovery an expired queued request is shed
        first."""
        eng = self.engine
        sched = eng.scheduler
        shed_now = 0
        if eng.fault_recovery:
            # deadline shed pre-pass: an expired queued (WAITING/SWAPPED)
            # request is dropped before it can consume admission or pages —
            # under a fault storm BE deadlines turn backlog into shed work
            # instead of batch-wide stall
            now = eng.clock()
            for req in [r for r in rt.queue
                        if r.deadline is not None and now > r.deadline]:
                self._shed(rt, req, "deadline")
                shed_now += 1
        report = QuantumReport(rt.spec.name, rt.spec.priority,
                               budget=sched.budget_for(rt.spec.priority))
        dec = sched.decode_slots(rt)
        if dec and eng.grow_pages and rt.kv is not None:
            dec, report.swap_out_pages = self._ensure_growth(rt, dec)
        if dec:
            self._decode(rt, dec)
            report.decode_tokens = len(dec)
            if eng.arrival_hook is not None:
                eng.arrival_hook(len(dec))
        admitted = sched.admit(rt, eng)
        if rt.host is not None:
            report.swap_in_pages = self._swap_progress(rt)
        if rt.chunk_fn is not None:
            chunks = sched.prefill_chunks(rt, len(dec))
            if chunks:
                report.prefill_tokens = self._run_chunks(rt, chunks)
        elif admitted:
            report.prefill_tokens = self._prefill_monolithic(rt, admitted)
        progressed = bool(dec or admitted or report.prefill_tokens
                          or report.swap_in_pages or report.swap_out_pages
                          or shed_now)
        if progressed:
            eng.quantum_log.append(report)
            tr = eng.tracer
            if tr.enabled("quantum"):
                tr.instant(
                    "quantum", rt.spec.priority, eng.clock(),
                    f"{eng._trace_prefix}quanta/{rt.spec.name}",
                    tenant=rt.spec.name, step=eng._step_idx,
                    decode_tokens=report.decode_tokens,
                    prefill_tokens=report.prefill_tokens,
                    budget=report.budget,
                    swap_in_pages=report.swap_in_pages,
                    swap_out_pages=report.swap_out_pages)
        return progressed

    def run_until_idle(self, max_steps: int = 100_000, horizon=None) -> int:
        eng = self.engine
        n = stall = 0
        while n < max_steps:
            if eng.step():
                n += 1
                stall = 0
                continue
            # under a fault plane a quantum may legitimately defer (alloc
            # window, swap backoff) — idle means no tenant has work, not
            # one workless step; the stall cap bounds a wedged storm
            if eng.faults is None or stall >= 10_000 \
                    or not any(rt.has_work() for rt in eng.tenants.values()):
                break
            stall += 1
        return n


class _SimBackend:
    """Drives the discrete-event contention simulator with the engine's
    request stream (pod-scale what-if: Figs. 5/6/11/12)."""

    def __init__(self, engine: "ServingEngine", device="tpu-v5e",
                 policy: str = "sgdrc"):
        self.engine = engine
        self.dev = GPU_DEVICES[device] if isinstance(device, str) else device
        self.policy_kind = policy
        self.result = None

    def add_tenant(self, rt: _TenantRT):
        pass   # kernel sequences are derived lazily from the request stream

    def quantum(self, rt: _TenantRT) -> bool:
        raise RuntimeError("sim backend executes via run_until_idle(horizon=)")

    def run_until_idle(self, max_steps: int = 100_000, horizon=None) -> int:
        eng = self.engine
        plan = eng.plan
        built = []
        t_max = 0.0
        for name, rt in eng.tenants.items():
            pending = sorted(rt.queue, key=lambda r: r.t_submit)
            arrivals = [r.t_submit for r in pending]
            if arrivals:
                t_max = max(t_max, arrivals[-1])
            # explicit sim_seq keeps the scenario's pure-prefill modeling
            # (fig12 etc.); stream-derived tenants split the request into a
            # prompt-sized prefill plus per-step decode kernels, so the
            # generated tokens are costed once, in the decode phase
            steps = 0
            if rt.sim_seq is not None:
                S = rt.sim_seq
            elif pending:
                S = max(len(pending[0].tokens), 1)
                steps = pending[0].max_new
            else:
                S = eng.max_seq
            B = max(1, rt.spec.batch_size)
            # prefix-cache: replay the stream through a token-only radix
            # tree to estimate the mean cached-prefix length — the cost
            # model then charges prefill traffic only for the uncached
            # suffix (the bandwidth the sharing returns to the budget)
            prefix_est = 0
            if eng.prefix_cache and pending and rt.sim_seq is None:
                est = PrefixCache(eng.page_size)
                seen = []
                for r in pending:
                    seen.append(min(est.match_len(r.tokens),
                                    max(len(r.tokens) - 1, 0)))
                    est.insert_tokens(r.tokens)
                prefix_est = int(np.mean(seen)) if seen else 0
            # chunked-prefill modeling: with a chunk_size the prefill phase
            # becomes one kernel per chunk (the simulator's preemption
            # boundary, like the engine's quanta) and the cost model
            # charges the per-chunk KV re-read + weight re-read tax
            kern = request_kernels(rt.cfg, B, S, "prefill", self.dev,
                                   rt.max_kernels, prefix=prefix_est,
                                   chunk=eng.chunk_size,
                                   tile=(eng.preempt_tile
                                         if not rt.spec.is_ls else None))
            n_prefill_k = len(kern)
            # decode phase carries the KV-cache *write* traffic of the
            # engine's actual decode path — paged appends are O(tokens);
            # whole-row mask-scatter rewrites the window. Kept at (chunked)
            # step granularity so the simulator can still preempt/readmit
            # at decode-step boundaries, like the real engine's quanta.
            if steps > 0:
                dec = request_kernels(
                    rt.cfg, B, S + steps, "decode", self.dev,
                    rt.max_kernels,
                    kv_write="paged" if eng.paged else "scatter")
                f = sum(k.flops for k in dec)
                b = sum(k.bytes for k in dec)
                n_chunks = min(steps, max(1, rt.max_kernels))
                per = steps / n_chunks
                step_k = Kernel(f * per, b * per,
                                b / self.dev.hbm_bw > f / self.dev.peak_flops)
                kern = kern + [step_k] * n_chunks
            if rt.sim_swap_bytes > 0:
                # KV swap traffic modeled as one memory-bound kernel at the
                # resume point (right after prefill): with coloring on, its
                # bytes drain at the owning class's ch_be bandwidth split,
                # so BE swap storms never stretch LS decode gaps
                kern = (kern[:n_prefill_k]
                        + [Kernel(0.0, float(rt.sim_swap_bytes), True)]
                        + kern[n_prefill_k:])
            tn = Tenant(name, rt.spec.priority, kern,
                        arrivals=arrivals or None,
                        closed_loop=rt.closed_loop,
                        prefill_kernels=n_prefill_k if steps > 0 else None)
            built.append((rt, pending, tn))
        if horizon is None:
            horizon = t_max * 1.05 + 1.0
        sm_be = plan.sm_be if plan is not None else ComputePolicy().sm_be
        policy = ComputePolicy(kind=self.policy_kind, sm_be=sm_be)
        sim = GPUSimulator(self.dev, policy, coloring=eng.coloring,
                           ch_be=eng.ch_be, controller=eng.controller,
                           control_dt=eng.control_dt,
                           migration_bytes=eng.migration_bytes,
                           faults=eng.faults,
                           tracer=(eng.tracer if eng.tracer.level >= 0
                                   else None))
        res = sim.run([tn for _, _, tn in built], horizon)
        eng.migrated_bytes += sim.migrated_bytes
        total = 0
        for rt, pending, tn in built:
            if tn.closed_loop:
                rt.sim_completed = tn.completed
                total += tn.completed
                continue
            for req, lat in zip(pending, tn.latencies):
                req.t_done = req.t_submit + lat
                req.output = []
                rt.done.append(req)
                rt.queue.remove(req)
                eng._trace_done(rt, req)
                total += 1
        self.result = res
        eng.sim_result = res
        # virtual timelines all start at t=0, so across repeated drains the
        # widest horizon is the serving window metrics() divides by
        eng._elapsed = max(eng._elapsed or 0.0, res.horizon)
        return total


class ServingEngine:
    """The serving engine on a torch device. See module docstring.

    Parameters of note (the reference's names and defaults):
      max_seq      per-slot window cap (prompt + generated tokens).
      backend      "torch" (real execution on ``torch_device``) or "sim"
                   (the contention simulator; arrival times via
                   ``submit(at=)``, completions via
                   ``run_until_idle(horizon=)``).
      device       DeviceSpec or name for the sim backend.
      policy       ComputePolicy kind for the sim backend.
      control_dt   sim backend: simulated seconds between control ticks.
      migration_bytes  sim backend: memory-system stall charged per unit
                   of ``ch_be`` a transition moves.
      plan         ResourcePlan; ``sm_be`` is BE's share of contended quanta,
                   ``prefill_budget`` caps BE prefill tokens per quantum,
                   ``ch_be`` sets the arena's LS/BE channel split.
      coloring     carve tenants' KV from a ColoredArena of
                   ``arena_bytes`` over ``hash_model`` (a channel hash with
                   ``num_channels``, ``granularity`` and ``channel_of``).
      ch_be        BE channel share when no plan is given.
      slots_ls/be  decode-slot pool size per tenant class.
      paged        page-table KV admission (PagedKVCache) instead of
                   whole-row slots.
      page_size    tokens per KV page (paged mode).
      kv_pages     page-pool size per tenant (default: the dense-row
                   capacity, ``slots * ceil(max_seq / page_size)``).
      prefix_cache radix-tree copy-on-write KV page sharing (requires
                   ``paged``); ``prefix_min_hit`` is the least hit fraction
                   admission uses.
      grow_pages   admit on ``ceil(prompt / page_size)`` pages and map decode
                   pages at boundary crossings; on pool exhaustion the
                   youngest younger request is preempted, or swapped out
                   with ``swap`` (requires ``paged``).
      swap         per-tenant host KV tier (HostSwapPool): victims' page
                   groups and evicted prefix leaves move to the host and
                   fault back in, at most ``swap_quantum_pages`` a quantum.
      cold_dtype   host storage: "int8" (per-page abs-max scale, bounded
                   error) or "fp16" (the pool's own bits: exact).
      use_flash    attention core through the CUDA kernels (the plain
                   versions when the device is the CPU).
      chunk_size   max prefill tokens a request advances per quantum
                   (None = whole prompt per quantum).
      token_budget per-class per-quantum token cap: decode tokens first,
                   prefill chunks fill the remainder.
      preempt_tile BE prefill tiles with a preemption point after each.
      controller   OnlineController / PlanSchedule: re-plans at quantum
                   boundaries, every ``control_interval`` quanta (module
                   docstring).
      chunk_governor  ChunkGovernor: SLO-driven chunk_size and BE prefill
                   budget on the same control tick.
      seed         tie-break seed for deterministic tenant ordering.
      faults       FaultPlane: seeded injection at the host tier, the
                   allocator and the control tick (module docstring).
      fault_recovery  master switch for the recovery paths (deadline
                   shedding, swap retry with backoff, the watchdog, the
                   cold-page CRC check, the degradation ladder).
      fault_budget recoveries per degradation-ladder rung (per tenant).
      max_queue    per-tenant submit backpressure bound (excess rejects).
      swap_retry_limit  swap-in retries before preempt-restart.
      deadlock_patience  consecutive victimless growth stalls before a
                   grow deadlock is declared (and, for BE under recovery,
                   the youngest active request shed).
      watchdog_quanta  LS-starvation window before the safe-plan snap
                   (default: 4 control intervals when a fault plane and a
                   controller are both present, else off).
      safe_plan    the watchdog's target (default: the frontier's most
                   conservative entry, else ``faults.safe_floor(plan)``).
      torch_device "cuda" (default) or "cpu" on the torch backend. Raises
                   if CUDA is asked for and absent. The sim backend creates
                   no tensor and ignores it (``self.torch_device`` is None).
    """

    def __init__(self, max_seq: int = 128, *, backend: str = "torch",
                 plan: Optional[ResourcePlan] = None, coloring: bool = False,
                 ch_be: float = 1 / 3, arena_bytes: int = 64 << 20,
                 hash_model=None, now_fn=None, slots_ls: int = 4,
                 slots_be: int = 4, paged: bool = False, page_size: int = 8,
                 kv_pages: Optional[int] = None, use_flash: bool = False,
                 chunk_size: Optional[int] = None,
                 token_budget: Optional[int] = None, hit_aware: bool = True,
                 device="tpu-v5e", policy: str = "sgdrc",
                 controller=None, control_interval: int = 4,
                 control_dt: float = 0.02, prefix_cache: bool = False,
                 prefix_min_hit: float = 0.0,
                 migration_bytes: float = 0.0,
                 seed: int = 0, grow_pages: bool = False, swap: bool = False,
                 cold_dtype: str = "int8", swap_quantum_pages: int = 4,
                 faults: Optional[FaultPlane] = None,
                 fault_recovery: bool = True, fault_budget: int = 8,
                 max_queue: int = 4096, swap_retry_limit: int = 3,
                 deadlock_patience: int = 8,
                 watchdog_quanta: Optional[int] = None,
                 safe_plan: Optional[ResourcePlan] = None,
                 tracer=None, trace_name: str = "",
                 preempt_tile: Optional[int] = None,
                 arrival_hook=None, chunk_governor=None,
                 torch_device="cuda"):
        if backend not in ("torch", "sim"):
            raise ValueError(f"unknown backend {backend!r}")
        if (grow_pages or swap) and backend == "torch" and not paged:
            raise ValueError("grow_pages/swap require paged=True")
        if prefix_cache and backend == "torch" and not paged:
            raise ValueError("prefix_cache=True requires paged=True")
        self.torch_device = (resolve_device(torch_device)
                             if backend == "torch" else None)
        self.backend_name = backend
        self.max_seq = max_seq
        # telemetry plane (obs): the engine always owns a tracer so emission
        # sites stay branch-free; the default level-"off" tracer drops
        # everything. All timestamps come from self.clock.
        self.tracer = tracer if tracer is not None else obs.Tracer("off",
                                                                   ring=1)
        self._trace_prefix = f"{trace_name}/" if trace_name else ""
        self.registry = obs.MetricsRegistry()
        self.paged = paged
        self.page_size = page_size
        self.kv_pages = kv_pages
        self.use_flash = use_flash
        self.chunk_size = chunk_size
        # KV memory hierarchy (module docstring)
        self.grow_pages = grow_pages
        self.swap = swap
        assert cold_dtype in ("int8", "fp16"), cold_dtype
        self.cold_dtype = cold_dtype
        self.swap_quantum_pages = max(int(swap_quantum_pages), 1)
        # construction-time default the tidal controller restores when a
        # plan stops carrying a swap_quantum_pages override (apply_plan)
        self._default_swap_quantum = self.swap_quantum_pages
        # disaggregation seams (serving.disagg): chunk_hook(rt, req) fires
        # after each mid-prompt chunk commits (the KV page-group stream
        # overlaps the remaining prefill); migrate_hook(rt, req) fires when
        # prefill completes on a still-live request and returns True to
        # take the slot (the request leaves this engine)
        self.chunk_hook = None
        self.migrate_hook = None
        self.prefix_cache = prefix_cache
        self.prefix_min_hit = prefix_min_hit
        self.preempt_tile = (None if not preempt_tile
                             else max(int(preempt_tile), 1))
        self.arrival_hook = arrival_hook
        self.preempt_hook = None
        self.preempt_aborts = 0
        self.preempt_waits: List[float] = []
        self._aborted_rids: set = set()
        # SLO-driven chunk sizing: a ChunkGovernor rides the control tick
        # and retunes chunk_size/prefill_budget from the windowed LS TBT
        # p99 (cause "chunk_adapt" in the transition log)
        self.chunk_governor = chunk_governor
        self.scheduler = TokenBudgetScheduler(
            chunk_size=chunk_size, budget_ls=token_budget,
            budget_be=token_budget,
            prefill_budget_be=(plan.prefill_budget
                               if plan is not None else None),
            hit_aware=hit_aware, prefix_min_hit=prefix_min_hit)
        self.quantum_log: List[QuantumReport] = []
        # resplit-aware migration costing: the torch backend accumulates the
        # arena's moved-page bytes (charged, never copied: the resplit is
        # placement bookkeeping); the sim backend charges migration_bytes *
        # |d ch_be| of memory-system stall per transition
        self.migration_bytes = migration_bytes
        self.migrated_bytes = 0
        self.tenants: Dict[str, _TenantRT] = {}
        self.clock = now_fn or time.perf_counter
        self._t0 = self.clock()     # epoch for sim-backend virtual arrivals
        self._rid = 0
        self.plan = plan
        self.coloring = coloring
        self.ch_be = plan.ch_be if plan is not None else ch_be
        # BE quantum share: fraction of engine quanta BE receives while LS
        # work is pending (None/0 -> strict LS priority)
        self.sm_be = plan.sm_be if plan is not None else 0.0
        self._be_credit = 0.0
        # online control plane (module docstring): a decide()-bearing
        # controller makes the plan time-varying at step boundaries
        self.controller = controller
        self.control_interval = max(int(control_interval), 1)
        self.control_dt = control_dt
        # fault plane (module docstring): fault_recovery gates every
        # recovery path at once (off = the naive ablation: blind retries,
        # no watchdog, no shedding, unverified cold pages)
        self.faults = faults
        if faults is not None and tracer is not None:
            faults.tracer = self.tracer
        self.fault_recovery = fault_recovery
        self.fault_budget = max(int(fault_budget), 1)
        self.max_queue = max(int(max_queue), 1)
        self.swap_retry_limit = max(int(swap_retry_limit), 0)
        self.deadlock_patience = max(int(deadlock_patience), 1)
        if (watchdog_quanta is None and faults is not None
                and controller is not None and fault_recovery):
            watchdog_quanta = 4 * self.control_interval
        self.watchdog_quanta = watchdog_quanta
        self.safe_plan = safe_plan
        self.watchdog_trips = 0
        self.missed_ticks = 0
        self.stale_signals = 0
        self._stale_sig = None
        self._last_ls_step: Optional[int] = None
        self._ls_work_since: Optional[int] = None
        self.transitions: List[dict] = []
        self._applied_plan = None
        self._last_ctl_step: Optional[int] = None
        self._ctl_done_idx: Dict[str, int] = {}
        self._ctl_tbt_idx: Dict[str, int] = {}
        self.slots_ls, self.slots_be = slots_ls, slots_be
        self.events: List[tuple] = []   # (quantum_idx, tenant, class)
        # deterministic tenant tie-breaking: ranks drawn from a seeded rng
        # at add_tenant, so equal-arrival picks are stable across runs
        self._tie_rng = np.random.default_rng(seed)
        self._tie_rank: Dict[str, float] = {}
        self._step_idx = 0
        self.sim_result = None
        self._elapsed = None
        self._last_window = None
        self.arena = None
        if backend == "torch":
            self.backend = _TorchBackend(self)
        else:
            self.backend = _SimBackend(self, device=device, policy=policy)
        if coloring and backend == "torch":
            assert hash_model is not None
            self.arena = ColoredArena(arena_bytes, hash_model.channel_of,
                                      hash_model.num_channels,
                                      hash_model.granularity)
            self.ls_ch, self.be_ch = split_channels(
                hash_model.num_channels, self.ch_be)

    # ------------------------------------------------------------------
    def add_tenant(self, spec: TenantSpec, cfg: ModelConfig, params=None,
                   seed: Optional[int] = None, n_slots: Optional[int] = None,
                   closed_loop: bool = False, sim_seq: Optional[int] = None,
                   max_kernels: int = 24, sim_swap_bytes: int = 0):
        """Register a tenant. Torch backend: ``params`` (the port's param
        tree, e.g. from ``bridge.params_from_numpy``) is moved to the
        engine's device in the activation dtype; ``None`` draws random
        weights from ``seed`` (default: a crc32 of the tenant's name). Sim
        backend: no weights; ``closed_loop``, ``sim_seq``, ``max_kernels``
        and ``sim_swap_bytes`` shape the tenant's modeled kernel stream."""
        if self.backend_name == "torch":
            tf.check_supported(cfg)
            if cfg.encoder or cfg.vision:
                raise ValueError(
                    f"{cfg.name}: the engine serves decoder-only models; a "
                    "request carries tokens only, and this model needs "
                    "audio frames or image features (run it through "
                    "repro_torch.models.transformer)")
            act = dt(cfg.activation_dtype)
            if params is None:
                params = tf.init_params(
                    cfg, seed if seed is not None
                    else zlib.crc32(spec.name.encode()),
                    device=self.torch_device, dtype=act)
            else:
                params = tf.tree_map(
                    lambda a: a.to(self.torch_device,
                                   act if a.is_floating_point()
                                   else a.dtype),
                    params)
        n_slots = n_slots or (self.slots_ls if spec.is_ls else self.slots_be)
        row_bytes = chans = None
        if self.arena is not None:
            chans = self.ls_ch if spec.is_ls else self.be_ch
            if not self.paged:
                # whole-row admission: the arena must hold one dense
                # [max_seq] KV row per slot — cap the pool to what the
                # class's colored bytes fit (paged mode instead allocates
                # per-request page groups at admission)
                row_bytes = kv_bytes_per_token(cfg) * self.max_seq
                cap = (self.arena.free_pages(chans) * self.arena.granularity
                       // max(row_bytes, 1))
                if cap < 1:
                    raise OutOfColoredMemory(
                        f"{spec.name}: arena cannot hold one KV row")
                n_slots = min(n_slots, int(cap))
        rt = _TenantRT(spec, cfg, params, n_slots=n_slots,
                       closed_loop=closed_loop, sim_seq=sim_seq,
                       max_kernels=max_kernels, sim_swap_bytes=sim_swap_bytes)
        self.backend.add_tenant(rt)
        self._tie_rank[spec.name] = float(self._tie_rng.random())
        if self.arena is not None and not self.paged:
            # SSM-state tenants have no attention KV; keep a nonzero slice
            # so their placement is still tracked/colored
            self.arena.alloc(spec.name,
                             max(row_bytes * rt.n_slots, 1024), chans)
            rt.alloc_name = spec.name
        self.tenants[spec.name] = rt
        return rt

    def submit(self, tenant: str, tokens, max_new: int = 8, at=None,
               deadline: Optional[float] = None):
        """Queue a request. ``at`` overrides the submit timestamp (virtual
        arrival time for the sim backend's scenario traces); sim-backend
        submissions without ``at`` default to engine-epoch-relative time.
        ``deadline`` is in clock units after submit: an expired request
        still WAITING/SWAPPED is load-shed instead of served late (a
        recovery path: no-op when ``fault_recovery`` is off). Malformed
        input raises (unknown tenant: KeyError; empty / non-1-D prompt:
        ValueError); an oversized prompt (torch backend only: the sim
        backend cost-models arbitrary shapes) or a full per-tenant queue
        (``max_queue``) is *rejected* — the request finishes immediately
        with ``failed=rejected=True``."""
        if tenant not in self.tenants:
            raise KeyError(f"unknown tenant {tenant!r}")
        rt = self.tenants[tenant]
        toks = np.asarray(tokens, np.int32)
        if toks.ndim != 1 or toks.size == 0:
            raise ValueError("prompt must be a non-empty 1-D token array")
        self._rid += 1
        if at is not None:
            t = float(at)
        elif self.backend_name == "sim":
            t = self.clock() - self._t0
        else:
            t = self.clock()
        req = Request(self._rid, tenant, toks, max_new, t,
                      deadline=(t + float(deadline)
                                if deadline is not None else None))
        oversize = toks.size > self.max_seq and self.backend_name != "sim"
        if oversize or len(rt.queue) >= self.max_queue:
            req.failed = req.rejected = True
            req.phase = Phase.FINISHED
            req.t_done = t
            req.output = []
            rt.rejected += 1
            rt.done.append(req)
            self._trace_done(rt, req)
            return req
        rt.queue.append(req)
        self.tracer.instant("request", "submit", t,
                            f"{self._trace_prefix}slo", rid=req.rid,
                            tenant=tenant, prompt_len=int(toks.size),
                            max_new=int(max_new))
        return req

    # -- telemetry plane (obs) ------------------------------------------
    def _tr_track(self, rt, slot) -> str:
        return f"{self._trace_prefix}{rt.spec.name}/slot{slot}"

    def _trace_enter(self, rt, req, phase_name: str):
        """Request admitted to a slot: open request + first phase spans."""
        tr = self.tracer
        if not tr.enabled("phase"):
            return
        t, track = self.clock(), self._tr_track(rt, req.slot)
        tr.begin("request", f"r{req.rid}", t, track, rid=req.rid,
                 tenant=rt.spec.name)
        tr.begin("phase", phase_name, t, track, rid=req.rid)

    def _trace_phase(self, rt, req, old: str, new: str):
        tr = self.tracer
        if not tr.enabled("phase"):
            return
        t, track = self.clock(), self._tr_track(rt, req.slot)
        tr.end("phase", old, t, track, rid=req.rid)
        tr.begin("phase", new, t, track, rid=req.rid)

    def _trace_leave(self, rt, req, slot, phase_name: str, outcome: str):
        """Request leaves its slot: close the open phase and request
        spans."""
        tr = self.tracer
        if not tr.enabled("phase") or slot is None:
            return
        t, track = self.clock(), self._tr_track(rt, slot)
        tr.end("phase", phase_name, t, track, rid=req.rid)
        tr.end("request", f"r{req.rid}", t, track, rid=req.rid,
               outcome=outcome)

    def _trace_done(self, rt, req):
        """Terminal accounting instant with the SLO verdict: ``ok`` is
        True/False against ``spec.slo_ms`` (milliseconds) or, failing that,
        the request's own ``deadline`` (clock units); None when the request
        carries no SLO at all. A violation also emits a ``violation``
        instant."""
        tr = self.tracer
        if not tr.enabled("request"):
            return
        t = req.t_done if req.t_done is not None else self.clock()
        lat = req.latency
        slo = rt.spec.slo_ms
        has_slo = slo is not None or req.deadline is not None
        if req.failed:
            ok = False if has_slo else None
        elif slo is not None and lat is not None:
            ok = bool(lat * 1e3 <= slo)
        elif req.deadline is not None:
            ok = bool(t <= req.deadline)
        else:
            ok = None
        lat_ms = lat * 1e3 if lat is not None else None
        track = f"{self._trace_prefix}slo"
        tr.instant("request", "done", t, track, rid=req.rid,
                   tenant=rt.spec.name, cls=rt.spec.priority, ok=ok,
                   latency_ms=lat_ms, t_submit=req.t_submit,
                   shed=req.shed, rejected=req.rejected)
        if ok is False:
            tr.instant("violation", "slo", t, track, rid=req.rid,
                       tenant=rt.spec.name, latency_ms=lat_ms,
                       t_submit=req.t_submit)

    # -- online control plane ------------------------------------------
    def _load_signal(self):
        """LoadSignal over the window since the last control tick, with the
        window's LS latency split into its phases: p99 TTFT (admission +
        prefill) and p99 TBT (inter-token gaps) next to the end-to-end SLO
        attainment."""
        q = a = slots = slo_ok = slo_n = 0
        ttfts, gaps = [], []
        for name, rt in self.tenants.items():
            if not rt.spec.is_ls:
                continue
            q += len(rt.queue)
            a += sum(r is not None for r in rt.active)
            slots += rt.n_slots
            i0 = self._ctl_done_idx.get(name, 0)
            self._ctl_done_idx[name] = len(rt.done)
            g0 = self._ctl_tbt_idx.get(name, 0)
            self._ctl_tbt_idx[name] = len(rt.tbt_gaps)
            gaps += rt.tbt_gaps[g0:]
            for r in rt.done[i0:]:
                if r.failed or r.latency is None:
                    continue
                if r.ttft is not None:
                    ttfts.append(r.ttft)
                if rt.spec.slo_ms is not None:
                    slo_n += 1
                    slo_ok += r.latency * 1e3 <= rt.spec.slo_ms
        # the window's samples flow through the registry's histograms and
        # the p99s are read back out of them (nearest-rank over log-linear
        # buckets, see obs.metrics), so the controller consumes the same
        # numbers metrics() reports
        reg = self.registry
        h_ttft = reg.histogram("ls_ttft_ms")
        h_tbt = reg.histogram("ls_tbt_ms")
        for v in ttfts:
            h_ttft.record(v * 1e3)
        for v in gaps:
            h_tbt.record(v * 1e3)
        if slo_n:
            reg.gauge("ls_slo_attainment").set(slo_ok / slo_n)
        sig = LoadSignal(ls_queued=q, ls_active=a, ls_slots=max(slots, 1),
                         ls_slo_attainment=(slo_ok / slo_n) if slo_n
                         else None,
                         ls_ttft_p99_ms=h_ttft.percentile(99, window=True),
                         ls_tbt_p99_ms=h_tbt.percentile(99, window=True))
        reg.gauge("ls_load").set(sig.ls_load)
        reg.tick()   # close the control window
        return sig

    def _maybe_control(self):
        """Consult the controller at the quantum boundary: every
        ``control_interval`` quanta, plus out-of-band whenever LS work shows
        up under a full-lending plan (the bounded tidal snap-back)."""
        due = (self._last_ctl_step is None
               or self._step_idx - self._last_ctl_step
               >= self.control_interval)
        if not due and self.sm_be >= 1.0:
            due = any(rt.spec.is_ls and rt.has_work()
                      for rt in self.tenants.values())
        if not due:
            return
        self._last_ctl_step = self._step_idx
        now = self.clock()
        if (self.faults is not None
                and self.faults.active("ctl_missed_tick", now) is not None):
            # control-plane fault: the tick is dropped on the floor — the
            # previous plan stays in force and the step() watchdog is the
            # backstop that re-asserts the LS guarantee
            self.missed_ticks += 1
            return
        sig = self._load_signal()
        # live prefix-hit feedback as a windowed gauge (hit tokens over
        # prompt tokens of every tenant's prefix cache)
        hit = measured_prefix_hit(self)
        self.registry.gauge("measured_prefix_hit").set(hit)
        tr = self.tracer
        if tr.enabled("gauge"):
            sig_track = f"{self._trace_prefix}signals"
            tr.counter("ls_load", now, sig.ls_load, track=sig_track)
            if sig.ls_slo_attainment is not None:
                tr.counter("ls_slo_attainment", now, sig.ls_slo_attainment,
                           track=sig_track)
            tr.counter("measured_prefix_hit", now, hit, track=sig_track)
        if (self.faults is not None
                and self.faults.active("ctl_stale_signal", now) is not None):
            # stale telemetry: the controller decides on the last healthy
            # window's signal instead of the current one
            self.stale_signals += 1
            if self._stale_sig is not None:
                sig = self._stale_sig
        else:
            self._stale_sig = sig
        if self.chunk_governor is not None:
            self._govern_chunks(sig, now)
        if self.controller is None:
            return
        plan = self.controller.decide(sig, t=float(self._step_idx))
        if plan is not self._applied_plan:
            cause = getattr(self.controller, "last_cause", None)
            if cause is None:
                cause = "initial" if self._applied_plan is None else "replan"
            self.apply_plan(plan, cause=cause)
        elif self.arena is not None:
            # drain leftover off-color pages from an earlier partial
            # migration (BE groups still borrowing LS channels) — but never
            # a pinned shared group: a prefix-tree page another slot's page
            # table still references stays put until its refs drop, then
            # drains to the current color here
            pinned = set()
            debt = {}
            for rt in self.tenants.values():
                if rt.prefix is not None:
                    pinned.update(rt.prefix.pinned_names())
                    debt.update(rt.prefix.drain_recolor())
            debt.update({n: a.channels
                         for n, a in self.arena.allocations.items()
                         if n not in pinned and n not in debt
                         and self.arena.isolation_violations(a)})
            if debt:
                self.arena.resplit(debt, pinned=pinned)
                self.migrated_bytes += self.arena.last_resplit["bytes"]

    def _govern_chunks(self, sig, now: float):
        """SLO-driven chunk sizing: feed the window's LS TBT p99 (the same
        registry histogram the controller reads) to the ChunkGovernor and
        adopt its decision — chunk_size plus the derived BE prefill budget
        — logged as a ``chunk_adapt`` transition next to plan moves."""
        decision = self.chunk_governor.update(sig.ls_tbt_p99_ms)
        if decision is None:
            return
        chunk, budget = decision
        self.chunk_size = chunk
        self.scheduler.chunk_size = chunk
        self.scheduler.set_prefill_budget(budget)
        self.transitions.append({"step": self._step_idx,
                                 "sm_be": float(self.sm_be),
                                 "ch_be": float(self.ch_be),
                                 "pages_moved": 0, "bytes_moved": 0,
                                 "pinned_groups": 0,
                                 "chunk_size": int(chunk),
                                 "prefill_budget": int(budget),
                                 "cause": "chunk_adapt"})
        self.tracer.instant("plan", "chunk_adapt", now,
                            f"{self._trace_prefix}plan",
                            sm_be=float(self.sm_be),
                            ch_be=float(self.ch_be),
                            chunk_size=int(chunk),
                            prefill_budget=int(budget),
                            step=self._step_idx)

    def _channel_sets(self, ch_be: float):
        """Engine-local channel sets for a plan's ``ch_be`` (the plan's own
        sets were drawn for the controller's DeviceSpec, whose channel
        count may differ from the hash model's). ``ch_be >= 1`` is the
        lending plan: BE may borrow every channel while LS keeps its
        assignment, so snap-back never migrates LS pages."""
        C = self.arena.num_channels
        if ch_be >= 1.0 - 1e-9:
            return self.ls_ch, tuple(range(C))
        return split_channels(C, ch_be)

    def apply_plan(self, plan: ResourcePlan, cause: str = "replan"):
        """Adopt a ResourcePlan at a step boundary: the BE quantum share
        moves immediately; a ``ch_be`` move resplits the arena (off-color
        pages migrate to the new sets) and recolors every KV page pool so
        future page groups land on the new split. Device pools and page
        tables are untouched — a mid-run plan change never alters tokens,
        and no device copy is made. Prefix-tree node groups whose pages a
        live page table still references are *pinned* out of the resplit
        (they drain later in :meth:`_maybe_control`). The migration's moved
        bytes are charged to ``migrated_bytes``."""
        prev = self._applied_plan
        self.sm_be = plan.sm_be
        # prefill-budget knob: tidal re-planning throttles BE prefill
        # tokens per quantum, not only BE's SM share
        self.scheduler.set_prefill_budget(
            getattr(plan, "prefill_budget", None))
        # swap-aware knob: a contended plan throttles BE host-tier fault
        # bandwidth (pages per quantum); a plan without the knob restores
        # the construction-time default
        sq = getattr(plan, "swap_quantum_pages", None)
        self.swap_quantum_pages = (self._default_swap_quantum if sq is None
                                   else max(int(sq), 1))
        moved = 0
        pinned = []
        if self.arena is not None and (prev is None
                                       or plan.ch_be != prev.ch_be):
            new_ls, new_be = self._channel_sets(plan.ch_be)
            mapping = {}
            for rt in self.tenants.values():
                chans = new_ls if rt.spec.is_ls else new_be
                if rt.kv is not None:
                    mapping.update(rt.kv.recolor(chans))
                    if rt.prefix is not None:
                        mapping.update(rt.prefix.recolor(chans))
                        pinned += rt.prefix.pinned_names()
                elif rt.alloc_name is not None:
                    mapping[rt.alloc_name] = chans
            self.ls_ch, self.be_ch = new_ls, new_be
            moved = sum(self.arena.resplit(mapping, pinned=pinned).values())
            self.migrated_bytes += self.arena.last_resplit["bytes"]
        self._applied_plan = plan
        self.transitions.append({"step": self._step_idx,
                                 "sm_be": plan.sm_be, "ch_be": plan.ch_be,
                                 "pages_moved": int(moved),
                                 "bytes_moved": int(
                                     moved * (self.arena.granularity
                                              if self.arena else 0)),
                                 "pinned_groups": len(pinned),
                                 "cause": cause})
        self.tracer.instant("plan", cause, self.clock(),
                            f"{self._trace_prefix}plan",
                            sm_be=float(plan.sm_be),
                            ch_be=float(plan.ch_be),
                            pages_moved=int(moved), step=self._step_idx)

    def _safe_plan(self) -> Optional[ResourcePlan]:
        """The conservative plan the watchdog snaps to: an explicit
        ``safe_plan`` wins; else the controller frontier's most conservative
        entry; else the current plan clamped to the hard floor
        (``faults.safe_floor``)."""
        if self.safe_plan is not None:
            return self.safe_plan
        fr = getattr(self.controller, "frontier", None)
        if fr is not None and getattr(fr, "entries", None):
            return fr.entries[-1][1]
        base = self._applied_plan or self.plan
        return safe_floor(base) if base is not None else None

    def _watchdog(self, ls_work: bool):
        """Controller watchdog (a recovery path): if LS has had work for
        ``watchdog_quanta`` consecutive steps without a single LS quantum
        executing, while the live plan is more generous to BE than the safe
        plan, snap to the safe plan immediately. This bounds the damage of
        a wedged or stale controller to one watchdog window."""
        if not ls_work:
            self._ls_work_since = None
            return
        if self._ls_work_since is None:
            self._ls_work_since = self._step_idx
        anchor = self._ls_work_since
        if self._last_ls_step is not None:
            anchor = max(anchor, self._last_ls_step)
        if self._step_idx - anchor < self.watchdog_quanta:
            return
        safe = self._safe_plan()
        if safe is None or self.sm_be <= safe.sm_be + 1e-9:
            # already at (or below) the safe share: nothing to snap; re-arm
            self._last_ls_step = self._step_idx
            return
        self.apply_plan(safe, cause="watchdog")
        self.transitions[-1]["watchdog"] = True
        self.watchdog_trips += 1
        self.tracer.instant("recovery", "watchdog", self.clock(),
                            f"{self._trace_prefix}recovery",
                            step=self._step_idx)
        self._last_ls_step = self._step_idx

    # ------------------------------------------------------------------
    def _pick(self, rts: List[_TenantRT]) -> List[_TenantRT]:
        """Earliest outstanding request first (FIFO across tenants), ties
        broken by each tenant's seeded rank."""
        return sorted(rts, key=lambda rt: (_earliest_outstanding(rt),
                                           self._tie_rank[rt.spec.name]))

    def step(self) -> bool:
        """One engine quantum: choose a tenant class via the plan's BE
        quantum share, then run one batched quantum for one tenant of that
        class. LS strictly preempts BE at this boundary when no plan grants
        BE a share. With an online controller or chunk governor attached
        this boundary is also where re-plans land."""
        if (self.controller is not None or self.chunk_governor is not None) \
                and self.backend_name == "torch":
            self._maybe_control()
        ls = [rt for rt in self.tenants.values()
              if rt.spec.is_ls and rt.has_work()]
        be = [rt for rt in self.tenants.values()
              if not rt.spec.is_ls and rt.has_work()]
        if (self.watchdog_quanta and self.fault_recovery
                and self.backend_name == "torch"):
            self._watchdog(bool(ls))
        if ls and be and self.sm_be > 0:
            # deficit counter: BE receives sm_be of contended quanta
            self._be_credit += self.sm_be
            if self._be_credit >= 1.0:
                self._be_credit -= 1.0
                pick = be
            else:
                pick = ls
        elif ls:
            pick = ls
        elif be:
            pick = be   # resource lending: BE runs at full rate when LS idles
        else:
            return False
        other = be if pick is ls else ls
        # a tenant whose queue head is blocked (paged mode: waiting on KV
        # pages) must not strand the rest: fall through to the next tenant
        # of the class, then to the other class
        for rt in self._pick(pick) + self._pick(other):
            if self.backend.quantum(rt):
                if rt.spec.is_ls:
                    self._last_ls_step = self._step_idx
                self.events.append((self._step_idx,
                                    rt.spec.name, rt.spec.priority))
                self._step_idx += 1
                return True
        # a workless or fully-deferred step still advances the quantum
        # index: swap retry backoffs and the watchdog window are measured
        # in _step_idx, and freezing it during a stall would turn a
        # transient fault window into a permanent wedge
        self._step_idx += 1
        return False

    def _class_counts(self):
        c = {"LS": [0, 0], "BE": [0, 0]}       # [completed, tokens]
        for rt in self.tenants.values():
            served = [r for r in rt.done if not r.failed]
            c[rt.spec.priority][0] += len(served) + rt.sim_completed
            c[rt.spec.priority][1] += sum(len(r.output or ()) for r in served)
        return c

    def run_until_idle(self, max_steps: int = 100_000, horizon=None) -> int:
        """Torch backend: run quanta until no tenant has work (returns
        #quanta). Sim backend: build tenants from the submitted stream, run
        the simulator over ``horizon`` and write completions back (returns
        #completed requests; the raw SimResult lands in
        ``self.sim_result``). Each call is one serving window: its rates
        land in ``metrics()['_window']``, next to the cumulative rollup."""
        t0 = self.clock()
        before = self._class_counts()
        mig0 = self.migrated_bytes
        n = self.backend.run_until_idle(max_steps=max_steps, horizon=horizon)
        if self.backend_name == "torch":
            win = self.clock() - t0
            self._elapsed = (self._elapsed or 0.0) + win
        else:
            # this drain's virtual horizon (cumulative _elapsed keeps the
            # widest horizon, set by the sim backend)
            win = self.sim_result.horizon if self.sim_result else 0.0
        after = self._class_counts()
        self._last_window = {"elapsed_s": win,
                             "migrated_bytes": int(self.migrated_bytes
                                                   - mig0)}
        for pri in ("LS", "BE"):
            done = after[pri][0] - before[pri][0]
            toks = after[pri][1] - before[pri][1]
            self._last_window[pri] = {
                "completed": done,
                "throughput_rps": done / win if win > 0 else None,
                "tokens_per_s": toks / win if win > 0 else None,
            }
        return n

    # ------------------------------------------------------------------
    @staticmethod
    def _pcts(vals, keys=("p50", "p99")):
        """{p50_ms, p99_ms} for a latency list in seconds; None entries when
        the list is empty. Nearest-rank (obs.metrics)."""
        return obs.pcts(vals, {k: float(k[1:]) for k in keys}, scale=1e3)

    def metrics(self):
        out = {}
        cls = {pri: {"done": [], "ttft": [], "tbt": [], "tokens": 0,
                     "slo_ok": 0, "slo_n": 0, "completed": 0}
               for pri in ("LS", "BE")}
        for name, rt in self.tenants.items():
            served = [r for r in rt.done if not r.failed]
            lats = [r.latency for r in served if r.latency is not None]
            ttfts = [r.ttft for r in served if r.ttft is not None]
            out[name] = {
                "completed": len(served) + rt.sim_completed,
                "failed": len(rt.done) - len(served),
                **self._pcts(lats),
                "ttft": self._pcts(ttfts),
                "tbt": self._pcts(rt.tbt_gaps),
                "peak_active": rt.peak_active,
            }
            if rt.kv is not None:
                out[name]["kv_pages"] = {"total": rt.kv.n_pages,
                                         "in_use": rt.kv.used_pages,
                                         "page_size": rt.kv.page_size}
            if rt.prefix is not None:
                out[name]["prefix_cache"] = rt.prefix.stats()
            if rt.chunk_aborts:
                out[name]["chunk_aborts"] = rt.chunk_aborts
            if rt.host is not None or rt.preemptions or rt.grow_stalls:
                sw = {"preemptions": rt.preemptions,
                      "swap_outs": rt.swap_outs,
                      "swap_ins": rt.swap_ins,
                      "grow_stalls": rt.grow_stalls,
                      "resume": self._pcts(rt.resume_gaps)}
                if rt.host is not None:
                    sw["host"] = rt.host.stats()
                out[name]["swap"] = sw
            if rt.prefill_tokens:
                out[name]["prefill_tokens"] = {
                    "admitted": rt.prefill_tokens,
                    "computed": rt.prefill_computed,
                    "saved": rt.prefill_tokens - rt.prefill_computed,
                }
            if (rt.rejected or rt.shed or rt.grow_deadlocks
                    or rt.swap_retries or rt.fault_recoveries
                    or rt.degraded):
                out[name]["faults"] = {
                    "rejected": rt.rejected,
                    "shed": rt.shed,
                    "grow_deadlocks": rt.grow_deadlocks,
                    "swap_retries": rt.swap_retries,
                    "recovered": dict(rt.fault_recoveries),
                    "degraded": list(rt.degraded),
                }
            c = cls[rt.spec.priority]
            c["done"] += lats
            c["ttft"] += ttfts
            c["tbt"] += rt.tbt_gaps
            c["completed"] += len(served) + rt.sim_completed
            c["tokens"] += sum(len(r.output or ()) for r in served)
            if rt.spec.slo_ms is not None:
                c["slo_n"] += len(lats)
                c["slo_ok"] += sum(l * 1e3 <= rt.spec.slo_ms for l in lats)
        elapsed = self._elapsed
        out["_class"] = {}
        for pri, c in cls.items():
            out["_class"][pri] = {
                "completed": c["completed"],
                **self._pcts(c["done"]),
                "ttft": self._pcts(c["ttft"]),
                "tbt": self._pcts(c["tbt"]),
                "throughput_rps": (c["completed"] / elapsed
                                   if elapsed else None),
                "tokens_per_s": (c["tokens"] / elapsed if elapsed else None),
                "slo_attainment": (c["slo_ok"] / c["slo_n"]
                                   if c["slo_n"] else None),
            }
        if self._last_window is not None:
            out["_window"] = self._last_window
        if self.preempt_tile or self.preempt_aborts:
            out["_preempt"] = {"tile": self.preempt_tile,
                               "aborts": self.preempt_aborts,
                               "wait": self._pcts(self.preempt_waits)}
        if self.chunk_governor is not None:
            out["_chunk_governor"] = self.chunk_governor.stats()
        if self.plan is not None:
            out["_plan"] = {"sm_be": self.plan.sm_be,
                            "ch_be": self.plan.ch_be,
                            "thres_dram": self.plan.thres_dram}
        applied = self._applied_plan
        if applied is not None or self.transitions:
            out["_online"] = {
                "sm_be": applied.sm_be if applied else None,
                "ch_be": applied.ch_be if applied else None,
                "transitions": len(self.transitions),
                "pages_moved": sum(t["pages_moved"]
                                   for t in self.transitions),
                "migrated_bytes": int(self.migrated_bytes),
            }
        if self.arena is not None:
            out["_coloring"] = {
                name: {"violations": self.arena.isolation_violations(a),
                       "pages": a.n_pages}
                for name, a in self.arena.allocations.items()}
        # fault-plane rollup: injected (observed) events vs. the recovery
        # actions they triggered, plus the degradation state — present
        # whenever a fault plane is attached or any recovery path fired
        fa = {"injected": dict(self.faults.counts())
              if self.faults is not None else {},
              "recovered": {}, "shed": 0, "rejected": 0,
              "grow_deadlocks": 0, "swap_retries": 0,
              "watchdog_trips": self.watchdog_trips,
              "missed_ticks": self.missed_ticks,
              "stale_signals": self.stale_signals,
              "degraded_tenants": {}}
        for name, rt in self.tenants.items():
            for k, v in rt.fault_recoveries.items():
                fa["recovered"][k] = fa["recovered"].get(k, 0) + v
            fa["shed"] += rt.shed
            fa["rejected"] += rt.rejected
            fa["grow_deadlocks"] += rt.grow_deadlocks
            fa["swap_retries"] += rt.swap_retries
            if rt.degraded:
                fa["degraded_tenants"][name] = list(rt.degraded)
        fa["degraded"] = bool(fa["degraded_tenants"])
        if self.faults is not None or fa["recovered"] or fa["shed"] \
                or fa["rejected"] or fa["grow_deadlocks"] \
                or fa["swap_retries"] or fa["watchdog_trips"]:
            out["faults"] = fa
        if (self.registry.ticks or self.registry.histograms
                or self.registry.gauges):
            out["_registry"] = self.registry.snapshot()
        if self.tracer.level >= 0:
            out["_trace"] = self.tracer.stats()
        return out
