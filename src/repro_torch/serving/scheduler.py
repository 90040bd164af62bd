"""Phase-aware chunked-prefill token-budget scheduler for the serving engine.

The engine's admission/phase logic lives here: requests carry an explicit
phase state machine (``WAITING -> PREFILLING(pos) -> DECODING -> FINISHED``)
and :class:`TokenBudgetScheduler` composes each engine quantum from a
per-class *token budget* — decode tokens first (one per active decoding
slot, so TBT keeps ticking), then prefill chunks of at most ``chunk_size``
tokens. A long prompt therefore prefills across several quanta instead of
occupying the device for one monolithic prefill call, which is what bounds
the decode-latency (TBT) spike a co-located long prefill used to inflict —
the temporal face of SGDRC's spatial partitioning (cf. the chunked-prefill /
space-time-scheduling literature the ROADMAP cites).

Composition rules (one quantum, one tenant):

  * **decode first** — every ``DECODING`` slot contributes one token; the
    class budget must cover at least the decode width (budgets below the
    slot count would stall decode, so decode is never clamped).
  * **admission** — :meth:`admit` moves ``WAITING`` requests into free slots
    (page-gated in paged mode, with the prefix cache's plan/evict loop).
    Admission itself costs no tokens: the prompt is computed by chunks.
    With ``hit_aware`` (and a prefix cache) the waiting queue is ordered by
    predicted cached-prefix length — ties FIFO — so under pool pressure the
    requests that need the fewest fresh pages admit first and the batch runs
    wider; admission still stops at the first unadmittable candidate of the
    ordered queue (no bypass past a blocked head).
  * **prefill chunks** — each ``PREFILLING`` slot advances by at most
    ``chunk_size`` tokens per quantum (``None`` = the whole remaining
    prompt), all chunks together bounded by the budget left after decode;
    a BE tenant is additionally bounded by the plan's ``prefill_budget``
    (the tidal controller's throttle on BE prefill, next to BE's SM share).
  * **seeding chunk** — the final prompt position L-1 is always issued as
    its own one-token chunk: an Sq == 1 cached-context prefill step is
    shape-identical to a decode step, so the first output token's logits —
    and with them every generated token — are bit-equal across chunk sizes,
    prefix-cache hits, and the seed's scan-of-decode-steps prefill.

A prefix-cache hit enters ``PREFILLING`` at ``replay_from``: its uncached
suffix flows through the same chunked path, batched across slots — there is
no separate one-token-per-step replay loop, which is why ``prefix_min_hit``
defaults to 0 (any full-page hit pays off).
"""
from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Dict, List, Optional

_INF = float("inf")


class Phase(Enum):
    """Request lifecycle in the serving engine (see module docstring).

    The KV hierarchy adds two states: a decode request whose page group was
    swapped out to the host tier re-queues as ``SWAPPED`` (no slot, pages on
    host); re-admission moves it to ``SWAPPING`` (slot + fresh pages held,
    host pages faulting back in over the PCIe bus a few per quantum) and
    from there to ``DECODING`` once the last page lands."""
    WAITING = "waiting"          # queued, no slot
    PREFILLING = "prefilling"    # slot + pages held; prompt partially computed
    DECODING = "decoding"        # prompt done, emitting tokens
    SWAPPED = "swapped"          # preempted to host tier, queued for re-entry
    SWAPPING = "swapping"        # slot held, host pages faulting back in
    FINISHED = "finished"        # done (or failed)


@dataclass
class PrefillChunk:
    """One slot's prompt chunk for this quantum: compute positions
    [start, start + length) of ``req``'s prompt into its cache rows."""
    req: object
    slot: int
    start: int
    length: int


@dataclass
class QuantumReport:
    """Per-quantum token accounting (the engine's ``quantum_log`` rows):
    the token-budget invariant is ``decode_tokens + prefill_tokens <=
    max(budget, decode_tokens)`` — decode is never clamped, prefill fills
    whatever budget decode leaves."""
    tenant: str
    priority: str
    decode_tokens: int = 0
    prefill_tokens: int = 0
    budget: Optional[int] = None
    swap_in_pages: int = 0       # host pages faulted back this quantum
    swap_out_pages: int = 0      # pages pushed to the host tier this quantum

    @property
    def tokens(self) -> int:
        return self.decode_tokens + self.prefill_tokens


def split_tiles(chunks: List[PrefillChunk], tile: Optional[int]) \
        -> List[PrefillChunk]:
    """Split a quantum's prefill chunks into preemption tiles of at most
    ``tile`` tokens each, preserving order and positions. Between any two
    tiles the engine holds a preemption point: it may abort the remainder
    and record partial ``prefill_pos``, and because a resumed chunk is just
    a smaller chunk (and the seeding position stays its own one-token
    chunk), tokens are bit-equal under any preemption pattern. ``tile``
    None/0 returns the chunks unchanged (chunk-granular preemption)."""
    if not tile or tile < 1:
        return list(chunks)
    out: List[PrefillChunk] = []
    for c in chunks:
        start, end = c.start, c.start + c.length
        L = len(c.req.tokens)
        while start < end:
            stop = min(start + tile, end)
            if stop == L and stop - start > 1:
                stop = L - 1         # keep the seeding token its own tile
            out.append(PrefillChunk(c.req, c.slot, start, stop - start))
            start = stop
    return out


class TokenBudgetScheduler:
    """Composes engine quanta from per-class token budgets (module
    docstring). Owned by the engine; the backend executes what it emits.

    Parameters:
      chunk_size    max prefill tokens one request advances per quantum
                    (None = whole remaining prompt — the monolithic
                    granularity, still through the chunked attention path).
      budget_ls/be  per-quantum token budget per class (None = unbounded).
                    Prefill receives ``budget - decode_width``.
      prefill_budget_be  extra cap on BE prefill tokens per quantum — the
                    ResourcePlan's ``prefill_budget`` knob lands here at
                    ``apply_plan`` so tidal re-planning can throttle BE
                    prefill independently of BE's SM share.
      hit_aware     order the waiting queue by predicted prefix-cache hit
                    size (ties FIFO) before admission.
      prefix_min_hit  minimum hit fraction to use a prefix-cache match
                    (0 = any full-page hit; the batched suffix path removed
                    the sequential-replay cost that motivated the old 12.5%
                    floor).
    """

    def __init__(self, *, chunk_size: Optional[int] = None,
                 budget_ls: Optional[int] = None,
                 budget_be: Optional[int] = None,
                 prefill_budget_be: Optional[int] = None,
                 hit_aware: bool = True, prefix_min_hit: float = 0.0):
        assert chunk_size is None or chunk_size >= 1
        # a zero budget could never issue a chunk: admission (which costs no
        # tokens) would strand requests in PREFILLING holding pages forever
        for b in (budget_ls, budget_be):
            if b is not None and b < 1:
                raise ValueError(f"token budget must be >= 1, got {b}")
        self.chunk_size = chunk_size
        self.budgets: Dict[str, Optional[int]] = {"LS": budget_ls,
                                                  "BE": budget_be}
        self.prefill_budget_be = None
        self.set_prefill_budget(prefill_budget_be)
        self.hit_aware = hit_aware
        self.prefix_min_hit = prefix_min_hit

    # -- budgets -------------------------------------------------------
    def budget_for(self, priority: str) -> Optional[int]:
        return self.budgets.get(priority)

    def set_prefill_budget(self, prefill_budget_be: Optional[int]):
        """Plan-transition hook (``ServingEngine.apply_plan``). Clamped to
        >= 1: a zero budget would strand admitted BE requests mid-prefill
        (holding pages) with nothing able to finish them."""
        self.prefill_budget_be = (None if prefill_budget_be is None
                                  else max(int(prefill_budget_be), 1))

    # -- decode --------------------------------------------------------
    def decode_slots(self, rt) -> List[int]:
        """Slots that emit one token this quantum — every DECODING slot
        (decode tokens come first and are never clamped by the budget)."""
        return [s for s, r in enumerate(rt.active)
                if r is not None and r.phase is Phase.DECODING]

    def swap_slots(self, rt) -> List[int]:
        """Slots mid swap-in fault — the engine restores a few host pages
        per quantum (its ``swap_quantum_pages`` pacing) until the page
        group is complete and the slot flips back to DECODING."""
        return [s for s, r in enumerate(rt.active)
                if r is not None and r.phase is Phase.SWAPPING]

    # -- admission -----------------------------------------------------
    def order_queue(self, rt) -> List:
        """Waiting queue in admission order: SWAPPED requests first (they
        were already admitted once and hold host-tier state whose value
        decays), then WAITING by predicted cached-prefix length descending
        when ``hit_aware`` (python sort is stable, so ties keep FIFO),
        plain FIFO otherwise."""
        swapped = [r for r in rt.queue if r.phase is Phase.SWAPPED]
        waiting = [r for r in rt.queue if r.phase is not Phase.SWAPPED]
        if self.hit_aware and rt.prefix is not None and len(waiting) > 1:
            waiting = sorted(waiting,
                             key=lambda r: -rt.prefix.match_len(r.tokens))
        return swapped + waiting

    def admit(self, rt, eng) -> List:
        """Move admissible WAITING requests into free slots (slot + pages
        only — the prompt is computed by subsequent prefill chunks).

        Whole-row mode admits one request per free slot. Paged mode is
        page-gated on the request's full extent; a prefix-cache match maps
        the cached pages into the slot (strictly fewer fresh pages) and
        starts the phase machine at the uncached suffix; under pool
        pressure cold cached pages are LRU-evicted before admission stalls.
        Requests that can never fit are failed rather than left to deadlock
        the queue. Admission stops at the first unadmittable candidate of
        the (possibly hit-ordered) queue — no bypass. An ``alloc_fail``
        fault window (kv_cache.alloc_fault) defers paged admission for the
        quantum instead — deferral, never eviction, so a transient
        allocator fault cannot flush the prefix tree."""
        free = [s for s, r in enumerate(rt.active) if r is None]
        taken: List = []
        if rt.kv is None:
            take = rt.queue[: len(free)]
            del rt.queue[: len(take)]
            now = eng.clock()
            for req in take:
                req.slot = free.pop(0)
                self._place(rt, req, replay_from=0, now=now, eng=eng)
                taken.append(req)
            return taken
        if rt.kv.alloc_fault():
            return taken
        for req in self.order_queue(rt):
            if not free:
                break
            if req.phase is Phase.SWAPPED:
                # re-admission of a swapped-out decode: its page-group size
                # is fixed (host keys), fresh pages are allocated now and
                # the engine faults the host pages in over the next quanta
                n = len(req.swap_keys)
                while not rt.kv.can_admit_pages(n):
                    if rt.prefix is None or not rt.prefix.evict_until(n):
                        break
                if not rt.kv.can_admit_pages(n):
                    break
                req.slot = free.pop(0)
                rt.kv.alloc_slot_pages(req.slot, n)
                req.phase = Phase.SWAPPING
                req.swap_cursor = 0
                rt.active[req.slot] = req
                rt.peak_active = max(rt.peak_active,
                                     sum(r is not None for r in rt.active))
                rt.queue.remove(req)
                taken.append(req)
                eng._trace_enter(rt, req, "swapping")
                continue
            full = min(len(req.tokens) + req.max_new, eng.max_seq)
            # growth mode admits on the prompt's pages only; decode pages
            # are allocated at page-boundary crossings (grow_slot), so the
            # can-never-fit check still uses the full extent
            need = (min(len(req.tokens), eng.max_seq)
                    if eng.grow_pages and not rt.grow_degraded else full)
            if rt.kv.pages_for(full) > rt.kv.n_pages:
                # can never fit, even with an empty pool: fail it rather
                # than deadlock the queue forever
                req.t_done = eng.clock()
                req.output = []
                req.failed = True
                req.phase = Phase.FINISHED
                rt.queue.remove(req)
                rt.done.append(req)
                eng._trace_done(rt, req)
                continue
            if rt.prefix is not None:
                # cold tier: re-adopt swapped-out prefix pages matching this
                # prompt before planning — a faulted page is a shared page
                # the plan doesn't have to re-prefill
                rt.prefix.fault_cold(req.tokens)
            plan, admitted = None, False
            while True:
                plan = (rt.prefix.plan(req.tokens, need)
                        if rt.prefix is not None else None)
                if plan is not None and plan.match_len < \
                        self.prefix_min_hit * len(req.tokens):
                    plan = None          # hit too small to bother mapping
                need_free = (plan.need_free if plan is not None
                             else rt.kv.pages_for(need))
                if rt.kv.can_admit_pages(need_free):
                    admitted = True
                    break
                # pool pressure: evict LRU zero-ref tree leaves, then
                # re-plan and re-check (the eviction may have dropped a
                # matched node, growing need_free). Terminates: each pass
                # either admits, fails to evict, or shrinks the tree.
                if rt.prefix is None or not rt.prefix.evict_until(need_free):
                    break
            if not admitted:
                break
            req.slot = free.pop(0)
            replay_from = 0
            if plan is not None:
                rt.prefix.acquire(plan, req.slot)
                req.hit_tokens = plan.match_len
                replay_from = plan.replay_from
            else:
                if rt.prefix is not None:
                    rt.prefix.note_miss(len(req.tokens))
                rt.kv.alloc_slot(req.slot, need)
            self._place(rt, req, replay_from=replay_from, now=eng.clock(),
                        eng=eng)
            rt.queue.remove(req)
            taken.append(req)
        return taken

    def _place(self, rt, req, *, replay_from: int, now: float, eng=None):
        req.phase = Phase.PREFILLING
        req.prefill_pos = replay_from
        req.t_admit = now
        rt.active[req.slot] = req
        rt.prefill_tokens += len(req.tokens)
        rt.peak_active = max(rt.peak_active,
                             sum(r is not None for r in rt.active))
        if eng is not None:
            eng._trace_enter(rt, req, "prefilling")

    # -- prefill chunks ------------------------------------------------
    def prefill_chunks(self, rt, decode_tokens: int) -> List[PrefillChunk]:
        """Chunk schedule for this quantum: each PREFILLING slot advances by
        at most ``chunk_size`` tokens, all slots together by at most the
        class budget minus this quantum's decode tokens (BE additionally by
        ``prefill_budget_be``). The final prompt position is always its own
        one-token chunk (the bit-stable seeding step, module docstring);
        when the per-slot allowance covers both, the body chunk and the
        seeding chunk run in the same quantum."""
        budget = self.budget_for(rt.spec.priority)
        allowance = _INF if budget is None else max(budget - decode_tokens, 0)
        if rt.spec.priority == "BE" and self.prefill_budget_be is not None:
            allowance = min(allowance, self.prefill_budget_be)
        chunks: List[PrefillChunk] = []
        per_slot = self.chunk_size or _INF
        for slot, req in enumerate(rt.active):
            if req is None or req.phase is not Phase.PREFILLING:
                continue
            L = len(req.tokens)
            start, spent = req.prefill_pos, 0
            while allowance >= 1 and spent < per_slot and start < L:
                room = int(min(per_slot - spent, allowance, L))
                end = L if start >= L - 1 else min(start + room, L - 1)
                chunks.append(PrefillChunk(req, slot, start, end - start))
                spent += end - start
                allowance -= end - start
                start = end
        return chunks
