"""Continuous-batching multi-tenant serving engine on PyTorch/CUDA: the
``repro.serving.engine.ServingEngine`` with a torch execution backend.

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

``paged=True`` keeps the KV cache in a :class:`~.kv_cache.PagedKVCache`
page pool (page-table admission); ``use_flash=True`` routes the attention
core through the CUDA flash-decode / chunked-prefill kernels. LS and BE
tenants share the device by quanta: ``plan.sm_be`` is the fraction of
contended quanta BE receives (with no plan BE is strictly preempted), and
``plan.prefill_budget`` caps BE prefill tokens per quantum.
``preempt_tile`` splits BE prefill chunks into tiles with a preemption
point after each executed wave (an LS arrival aborts the rest of the BE
quantum and is admitted in the same quantum).

PyTorch runs eagerly, so there is no compile step; pools and dense caches
are updated in place. Not ported yet (``NotImplementedError``): the prefix
cache, page growth, host swap, fault injection, the online controller and
chunk governor, coloring, the simulator backend and the disaggregation
hooks.
"""
from __future__ import annotations

import time
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.controller import ResourcePlan
from ..core.tenancy import TenantSpec
from ..models import transformer as tf
from ..models.common import dt
from .. import obs
from .kv_cache import PagedKVCache
from .scheduler import (Phase, QuantumReport, TokenBudgetScheduler,
                        split_tiles)


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
    rejected: bool = False         # submit backpressure / oversized prompt
    # phase state machine (serving.scheduler); ``prefill_pos`` is the next
    # prompt position to compute
    phase: Phase = Phase.WAITING
    prefill_pos: int = 0

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
    kv: Optional[PagedKVCache] = None       # page-table state (paged mode)
    prefix = None                           # prefix cache: not ported yet
    peak_active: int = 0                    # max concurrent decode slots seen
    prefill_tokens: int = 0                 # prompt tokens admitted
    prefill_computed: int = 0               # prompt tokens actually prefilled
    tbt_gaps: List[float] = field(default_factory=list)  # inter-token gaps
    chunk_aborts: int = 0                   # sub-chunk prefill preemptions
    rejected: int = 0                       # submit backpressure rejections

    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.active)


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
        """The tenant's batched decode and prefill-chunk forwards."""
        cfg = rt.cfg
        flash = self.engine.use_flash

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
        rt.chunk_fn = _chunk

    def add_tenant(self, rt: _TenantRT):
        eng = self.engine
        self._build_fns(rt)
        if eng.paged:
            rt.kv = PagedKVCache(rt.cfg, rt.n_slots, eng.max_seq,
                                 eng.page_size, n_pages=eng.kv_pages,
                                 name=rt.spec.name, device=eng.torch_device)
            rt.cache = rt.kv.init_pools()
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
        rt.pos[slot] = 0
        rt.last_tok[slot] = 0
        if rt.kv is not None:
            rt.kv.free_slot(slot)

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
        with its first output token; degenerate (max_new<=1) requests finish
        immediately."""
        eng = self.engine
        s = req.slot
        now = eng.clock()
        req.t_first = req.t_last = now
        eng._trace_phase(rt, req, req.phase.name.lower(), "decoding")
        req.phase = Phase.DECODING
        req.output = [int(first_tok)]
        rt.pos[s] = len(req.tokens)
        rt.last_tok[s] = req.output[0]
        if len(req.output) >= max(req.max_new, 1) or rt.pos[s] >= eng.max_seq:
            self._finish(rt, s)

    def _run_chunks(self, rt: _TenantRT, chunks) -> int:
        """Execute this quantum's prefill chunks: waves preserve per-slot
        chunk order, each wave batches equal-length chunks into one
        cached-context ``prefill_step`` call across the slot pool (rows not
        in the group sit at the write sentinel — writes drop, logits
        ignored); a chunk that reaches the end of its prompt seeds the
        request's first output token. Returns tokens computed.

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
                for c in group:
                    c.req.prefill_pos = c.start + Sq
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
                   and any(r.phase is Phase.WAITING for r in rt.queue)
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
            if len(req.output) >= max(req.max_new, 1) \
                    or rt.pos[s] >= eng.max_seq:
                self._finish(rt, s)

    def quantum(self, rt: _TenantRT) -> bool:
        """One scheduler-composed quantum: decode first (a request finishing
        here releases its KV pages before this quantum's admission pass),
        then admission (slots + pages only), then prefill chunks under the
        class token budget."""
        eng = self.engine
        sched = eng.scheduler
        report = QuantumReport(rt.spec.name, rt.spec.priority,
                               budget=sched.budget_for(rt.spec.priority))
        dec = sched.decode_slots(rt)
        if dec:
            self._decode(rt, dec)
            report.decode_tokens = len(dec)
            if eng.arrival_hook is not None:
                eng.arrival_hook(len(dec))
        admitted = sched.admit(rt, eng)
        chunks = sched.prefill_chunks(rt, len(dec))
        if chunks:
            report.prefill_tokens = self._run_chunks(rt, chunks)
        progressed = bool(dec or admitted or report.prefill_tokens)
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

    def run_until_idle(self, max_steps: int = 100_000) -> int:
        eng = self.engine
        n = 0
        while n < max_steps and eng.step():
            n += 1
        return n


def _not_ported(**opts):
    for name, value in opts.items():
        if value:
            raise NotImplementedError(
                f"ServingEngine({name}=...) is not ported yet")


class ServingEngine:
    """The serving engine on a torch device. See module docstring.

    Parameters of note (the reference's names and defaults):
      max_seq      per-slot window cap (prompt + generated tokens).
      plan         ResourcePlan; ``sm_be`` is BE's share of contended quanta,
                   ``prefill_budget`` caps BE prefill tokens per quantum.
      slots_ls/be  decode-slot pool size per tenant class.
      paged        page-table KV admission (PagedKVCache) instead of
                   whole-row slots.
      page_size    tokens per KV page (paged mode).
      kv_pages     page-pool size per tenant (default: the dense-row
                   capacity, ``slots * ceil(max_seq / page_size)``).
      use_flash    attention core through the CUDA kernels (the plain
                   versions when the device is the CPU).
      chunk_size   max prefill tokens a request advances per quantum
                   (None = whole prompt per quantum).
      token_budget per-class per-quantum token cap: decode tokens first,
                   prefill chunks fill the remainder.
      preempt_tile BE prefill tiles with a preemption point after each.
      seed         tie-break seed for deterministic tenant ordering.
      torch_device "cuda" (default) or "cpu". Raises if CUDA is asked for
                   and absent.
    """

    def __init__(self, max_seq: int = 128, *, backend: str = "torch",
                 plan: Optional[ResourcePlan] = None, coloring: bool = False,
                 now_fn=None, slots_ls: int = 4, slots_be: int = 4,
                 paged: bool = False, page_size: int = 8,
                 kv_pages: Optional[int] = None, use_flash: bool = False,
                 chunk_size: Optional[int] = None,
                 token_budget: Optional[int] = None, hit_aware: bool = True,
                 controller=None, prefix_cache: bool = False, seed: int = 0,
                 grow_pages: bool = False, swap: bool = False,
                 faults=None, max_queue: int = 4096,
                 tracer=None, trace_name: str = "",
                 preempt_tile: Optional[int] = None,
                 arrival_hook=None, chunk_governor=None,
                 torch_device="cuda"):
        if backend == "sim":
            raise NotImplementedError("the simulator backend is not ported "
                                      "yet")
        if backend != "torch":
            raise ValueError(f"unknown backend {backend!r}")
        _not_ported(coloring=coloring, controller=controller,
                    prefix_cache=prefix_cache, grow_pages=grow_pages,
                    swap=swap, faults=faults, chunk_governor=chunk_governor)
        self.torch_device = resolve_device(torch_device)
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
        self.grow_pages = False
        self.preempt_tile = (None if not preempt_tile
                             else max(int(preempt_tile), 1))
        self.arrival_hook = arrival_hook
        self.preempt_hook = None
        self.preempt_aborts = 0
        self.preempt_waits: List[float] = []
        self._aborted_rids: set = set()
        self.scheduler = TokenBudgetScheduler(
            chunk_size=chunk_size, budget_ls=token_budget,
            budget_be=token_budget,
            prefill_budget_be=(plan.prefill_budget
                               if plan is not None else None),
            hit_aware=hit_aware)
        self.quantum_log: List[QuantumReport] = []
        self.tenants: Dict[str, _TenantRT] = {}
        self.clock = now_fn or time.perf_counter
        self._rid = 0
        self.plan = plan
        self.max_queue = max(int(max_queue), 1)
        # BE quantum share: fraction of engine quanta BE receives while LS
        # work is pending (None/0 -> strict LS priority)
        self.sm_be = plan.sm_be if plan is not None else 0.0
        self._be_credit = 0.0
        self.slots_ls, self.slots_be = slots_ls, slots_be
        self.events: List[tuple] = []   # (quantum_idx, tenant, class)
        # deterministic tenant tie-breaking: ranks drawn from a seeded rng
        # at add_tenant, so equal-arrival picks are stable across runs
        self._tie_rng = np.random.default_rng(seed)
        self._tie_rank: Dict[str, float] = {}
        self._step_idx = 0
        self._elapsed = None
        self._last_window = None
        self.backend = _TorchBackend(self)

    # ------------------------------------------------------------------
    def add_tenant(self, spec: TenantSpec, cfg: ModelConfig, params=None,
                   seed: Optional[int] = None, n_slots: Optional[int] = None):
        """Register a tenant. ``params`` (the port's param tree, e.g. from
        ``bridge.params_from_numpy``) is moved to the engine's device in
        the activation dtype; ``None`` draws random weights from ``seed``
        (default: a crc32 of the tenant's name)."""
        tf.check_supported(cfg)
        act = dt(cfg.activation_dtype)
        if params is None:
            params = tf.init_params(
                cfg, seed if seed is not None
                else zlib.crc32(spec.name.encode()),
                device=self.torch_device, dtype=act)
        else:
            params = tf.tree_map(
                lambda a: a.to(self.torch_device,
                               act if a.is_floating_point() else a.dtype),
                params)
        n_slots = n_slots or (self.slots_ls if spec.is_ls else self.slots_be)
        rt = _TenantRT(spec, cfg, params, n_slots=n_slots)
        self.backend.add_tenant(rt)
        self._tie_rank[spec.name] = float(self._tie_rng.random())
        self.tenants[spec.name] = rt
        return rt

    def submit(self, tenant: str, tokens, max_new: int = 8, at=None):
        """Queue a request. ``at`` overrides the submit timestamp. Malformed
        input raises (unknown tenant: KeyError; empty / non-1-D prompt:
        ValueError); an oversized prompt or a full per-tenant queue
        (``max_queue``) is *rejected* — the request finishes immediately
        with ``failed=rejected=True``."""
        if tenant not in self.tenants:
            raise KeyError(f"unknown tenant {tenant!r}")
        rt = self.tenants[tenant]
        toks = np.asarray(tokens, np.int32)
        if toks.ndim != 1 or toks.size == 0:
            raise ValueError("prompt must be a non-empty 1-D token array")
        self._rid += 1
        t = float(at) if at is not None else self.clock()
        req = Request(self._rid, tenant, toks, max_new, t)
        if toks.size > self.max_seq or len(rt.queue) >= self.max_queue:
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
        """Terminal accounting instant with the SLO verdict against
        ``spec.slo_ms`` (None when the tenant has no SLO); a violation also
        emits a ``violation`` instant."""
        tr = self.tracer
        if not tr.enabled("request"):
            return
        t = req.t_done if req.t_done is not None else self.clock()
        lat = req.latency
        slo = rt.spec.slo_ms
        if slo is None:
            ok = None
        elif req.failed:
            ok = False
        else:
            ok = bool(lat is not None and lat * 1e3 <= slo)
        lat_ms = lat * 1e3 if lat is not None else None
        track = f"{self._trace_prefix}slo"
        tr.instant("request", "done", t, track, rid=req.rid,
                   tenant=rt.spec.name, cls=rt.spec.priority, ok=ok,
                   latency_ms=lat_ms, t_submit=req.t_submit,
                   shed=False, rejected=req.rejected)
        if ok is False:
            tr.instant("violation", "slo", t, track, rid=req.rid,
                       tenant=rt.spec.name, latency_ms=lat_ms,
                       t_submit=req.t_submit)

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
        BE a share."""
        ls = [rt for rt in self.tenants.values()
              if rt.spec.is_ls and rt.has_work()]
        be = [rt for rt in self.tenants.values()
              if not rt.spec.is_ls and rt.has_work()]
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
                self.events.append((self._step_idx,
                                    rt.spec.name, rt.spec.priority))
                self._step_idx += 1
                return True
        self._step_idx += 1
        return False

    def _class_counts(self):
        c = {"LS": [0, 0], "BE": [0, 0]}       # [completed, tokens]
        for rt in self.tenants.values():
            served = [r for r in rt.done if not r.failed]
            c[rt.spec.priority][0] += len(served)
            c[rt.spec.priority][1] += sum(len(r.output or ()) for r in served)
        return c

    def run_until_idle(self, max_steps: int = 100_000) -> int:
        """Run quanta until no tenant has work (returns #quanta). Each call
        is one serving window: its rates land in ``metrics()['_window']``,
        next to the cumulative rollup."""
        t0 = self.clock()
        before = self._class_counts()
        n = self.backend.run_until_idle(max_steps=max_steps)
        win = self.clock() - t0
        self._elapsed = (self._elapsed or 0.0) + win
        after = self._class_counts()
        self._last_window = {"elapsed_s": win}
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
                "completed": len(served),
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
            if rt.chunk_aborts:
                out[name]["chunk_aborts"] = rt.chunk_aborts
            if rt.prefill_tokens:
                out[name]["prefill_tokens"] = {
                    "admitted": rt.prefill_tokens,
                    "computed": rt.prefill_computed,
                    "saved": rt.prefill_tokens - rt.prefill_computed,
                }
            if rt.rejected:
                out[name]["rejected"] = rt.rejected
            c = cls[rt.spec.priority]
            c["done"] += lats
            c["ttft"] += ttfts
            c["tbt"] += rt.tbt_gaps
            c["completed"] += len(served)
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
        if self.plan is not None:
            out["_plan"] = {"sm_be": self.plan.sm_be,
                            "ch_be": self.plan.ch_be,
                            "thres_dram": self.plan.thres_dram}
        if (self.registry.ticks or self.registry.histograms
                or self.registry.gauges):
            out["_registry"] = self.registry.snapshot()
        if self.tracer.level >= 0:
            out["_trace"] = self.tracer.stats()
        return out
