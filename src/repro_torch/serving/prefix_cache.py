"""Prefix cache: radix-tree copy-on-write KV page sharing in the colored
arena (the "prefix-cache page sharing" follow-up of the paged KV cache).

Real multi-tenant traffic re-prefills the same KV pages over and over —
shared system prompts, few-shot templates, chat history. Every redundant
prefill burns exactly the VRAM bandwidth SGDRC's controller is trying to
lend to BE. This module caches committed KV pages in a radix tree keyed by
token ids, so a request whose prompt shares a prefix with earlier traffic
maps the cached pages *copy-on-write* into its page table and computes only
the uncached suffix:

  * **tree**: one-page nodes (edge label = exactly ``page_size`` token ids;
    only *full* pages enter the tree). Children with a common token prefix
    may coexist under one parent — divergence inside a page cannot split a
    page, so sibling edges are discriminated by longest-common-prefix at
    match time rather than by unique first tokens.
  * **sharing**: a hit maps node pages read-only into the slot's leading
    page-table entries (``PagedKVCache.share``). The page pool is the
    tenant class's :class:`~repro.core.coloring.allocator.ColoredArena`
    channel set, so shared pages stay inside the class's bandwidth
    partition; each node owns one arena group (``<tenant>:px<id>``).
  * **copy-on-write**: positions above the matched prefix are recomputed —
    batched cached-context prefill chunks of the uncached suffix
    (``tf.prefill_step`` via the engine's TokenBudgetScheduler; the old
    one-token-per-step masked replay loop is retired). A chunk or decode
    write that would land in a shared page forks it first (``fork_cow`` —
    device page copy + table remap), with the fork destinations reserved at
    admission so a fork can never fail on an emptied pool. Reads of a
    partially-valid shared page are safe: the cached-context paths mask
    positions above each query's own, and the suffix chunks overwrite every
    position they will later read.
  * **admission**: a partial hit needs strictly fewer free pages
    (``suffix + predicted forks`` instead of the full extent) and strictly
    fewer prefill FLOPs/bytes (only the suffix is computed) — extra
    admission capacity and lendable bandwidth at equal arena bytes. The
    scheduler's hit-aware ordering admits big hits first under pool
    pressure, and the batched suffix path makes any full-page hit worth
    taking (``prefix_min_hit`` defaults to 0).
  * **donation**: at admission the request's freshly prefilled full prompt
    pages are inserted into the tree (concurrent same-prefix requests
    share immediately); at eviction the remaining full pages — prompt tail
    plus generated tokens, for chat-history reuse — follow. Pages whose
    token chunk is already cached are skipped (no live remapping: the
    slot keeps reading the pages it computed, so tokens are bit-stable).
  * **eviction**: zero-ref leaves go LRU-first under pool pressure
    (:meth:`PrefixCache.evict_until`); a node is never evicted while any
    live page table maps its page.
  * **tidal interop**: at a ``ch_be`` re-plan, node groups with no live
    references recolor with everyone else; *referenced* node groups are
    **pinned** — excluded from the arena resplit so a migration never moves
    a shared page out from under another slot's page table — and drain to
    the new color once their refs drop (:meth:`drain_recolor`).

``PrefixCache(page_size)`` without a ``kv`` is a token-only estimator (no
pages): the sim backend replays a request stream through it to estimate the
mean cached-prefix length, which the cost model's ``prefix=`` parameter
turns into suffix-only prefill traffic.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from .faults import HostTierFault
from .kv_cache import PagedKVCache


def _lcp(a, b) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


class RadixNode:
    """One full KV page: edge label ``tokens`` (len == page_size), pool page
    id (None in estimator mode), live-reference count and LRU stamp."""
    __slots__ = ("tokens", "page", "name", "parent", "children", "ref",
                 "last_used")

    def __init__(self, tokens, page, parent, name=""):
        self.tokens = tuple(tokens)
        self.page = page
        self.name = name
        self.parent = parent
        self.children: Dict[int, List["RadixNode"]] = {}
        self.ref = 0
        self.last_used = 0

    def is_leaf(self) -> bool:
        return not any(self.children.values())


@dataclass
class AdmissionPlan:
    """What a prefix-cache hit buys one admission (all predicted exactly at
    admission time — the replay's write positions are deterministic)."""
    nodes: List[RadixNode]
    prompt_len: int           # prompt length L
    match_len: int            # cached tokens usable by this prompt
    replay_from: int          # first prompt position to (re)compute
    extent: int               # prompt + max_new, capped at max_seq
    n_shared: int             # tree pages mapped into the page table
    n_cow: int                # shared pages the replay will fork
    n_new: int                # fresh private pages (uncached suffix)

    @property
    def need_free(self) -> int:
        """Free pool pages this admission consumes — strictly fewer than
        the dense ``pages_for(extent)`` whenever n_shared > n_cow."""
        return self.n_new + self.n_cow


class PrefixCache:
    """Per-tenant radix tree over prompt token ids whose nodes own
    ref-counted pages of the tenant's :class:`PagedKVCache` pool."""

    def __init__(self, page_size: int, kv: Optional[PagedKVCache] = None):
        self.page_size = page_size
        self.kv = kv
        assert kv is None or kv.sharing, "PagedKVCache(sharing=True) required"
        self.root = RadixNode((), None, None)
        self.slot_nodes: Dict[int, List[RadixNode]] = {}
        self._tick = 0
        self._next_id = 0
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.prompt_tokens = 0
        self.evictions = 0
        self.inserted = 0
        # cold-tier hooks (set by the engine when swap is on): an evicted
        # leaf's page content moves to the host tier instead of dying, keyed
        # by its full root->leaf token path, and admission re-adopts
        # matching host pages before planning (fault_cold). All optional —
        # None keeps the discard-on-evict behaviour.
        self.cold_store = None       # (key, page) -> None: device -> host
        self.cold_loader = None      # (key, page) -> None: host -> device
        self.cold_has = None         # (key) -> bool
        self.cold_faults = 0
        self.cold_stores = 0
        # chaos plane: host-tier failures survived by the cold paths —
        # a failed store degrades to discard-on-evict, a failed load undoes
        # the page adoption (the suffix re-prefills from tokens instead of
        # serving a missing/corrupt cold page)
        self.cold_store_failures = 0
        self.cold_fault_failures = 0

    # -- tree walk -----------------------------------------------------
    def _walk(self, tokens):
        """Longest-prefix walk: (path nodes, matched token count). The walk
        descends only through full-edge matches; the last node may match
        partially (divergence or prompt end inside its page)."""
        path, i, n = [], 0, len(tokens)
        node = self.root
        while i < n:
            best, best_l = None, 0
            for c in node.children.get(tokens[i], []):
                l = _lcp(c.tokens, tokens[i:])
                if l > best_l:
                    best, best_l = c, l
            if best is None:
                break
            path.append(best)
            i += best_l
            if best_l < self.page_size:
                break
            node = best
        return path, i

    def match_len(self, tokens) -> int:
        """Cached-prefix length for ``tokens`` (estimator entry point)."""
        return self._walk(tuple(int(t) for t in tokens))[1]

    # -- admission -----------------------------------------------------
    def plan(self, tokens, extent: int) -> Optional[AdmissionPlan]:
        """Match a prompt against the tree. None = miss (cold admission).

        At least one prompt position is always recomputed (the last token's
        logits seed decode), so ``match_len`` is capped at ``L - 1``; the
        shared page holding the replayed positions is forked copy-on-write
        before the replay writes into it."""
        toks = tuple(int(t) for t in tokens)
        L = len(toks)
        path, raw = self._walk(toks)
        match = min(raw, L - 1)
        ps = self.page_size
        n_shared = -(-match // ps) if match > 0 else 0
        if n_shared == 0 or self.kv is None:
            return None
        nodes = path[:n_shared]
        replay_from = match
        n_total = self.kv.pages_for(extent)
        n_cow = max(0, n_shared - replay_from // ps)
        return AdmissionPlan(nodes=nodes, prompt_len=L, match_len=match,
                             replay_from=replay_from, extent=extent,
                             n_shared=n_shared, n_cow=n_cow,
                             n_new=n_total - n_shared)

    def note_miss(self, prompt_len: int):
        """Hit/miss accounting for a cold admission (no usable prefix)."""
        self.misses += 1
        self.prompt_tokens += prompt_len

    def acquire(self, plan: AdmissionPlan, slot: int):
        """Map the plan's shared pages into ``slot`` and allocate its
        private suffix + copy-on-write reserve. The caller must have
        checked ``kv.can_admit_pages(plan.need_free)``."""
        kv = self.kv
        self._tick += 1
        for nd in plan.nodes:
            nd.ref += 1
            nd.last_used = self._tick
        kv.share(slot, [nd.page for nd in plan.nodes])
        kv.reserve(slot, plan.n_cow)
        kv.alloc_suffix(slot, plan.extent)
        self.slot_nodes[slot] = list(plan.nodes)
        self.hits += 1
        self.hit_tokens += plan.match_len
        self.prompt_tokens += plan.prompt_len

    # -- donation ------------------------------------------------------
    def donate(self, slot: int, stream, upto: int):
        """Insert the slot's committed full pages into the tree. ``stream``
        is the slot's KV token stream (prompt, then fed-back outputs) and
        ``upto`` the number of positions written. Chunks already cached are
        skipped — the slot keeps its own pages, no live remap."""
        kv = self.kv
        ps = self.page_size
        n_full = min(int(upto), kv.max_seq) // ps
        node = self.root
        self._tick += 1
        refs = self.slot_nodes.setdefault(slot, [])
        for j in range(n_full):
            chunk = tuple(int(t) for t in stream[j * ps:(j + 1) * ps])
            nxt = self._child(node, chunk)
            if nxt is not None:
                nxt.last_used = self._tick
                node = nxt
                continue
            if j in kv.slot_shared_idx[slot]:
                # a tree-owned page off the walked path — a COW fork
                # re-diverged the stream; nothing below here is donatable
                break
            name = f"{kv.name}:px{self._next_id}"
            self._next_id += 1
            nd = RadixNode(chunk, None, node, name)
            nd.page = kv.transfer_to_tree(slot, j, name)
            nd.ref = 1                       # the donor still maps the page
            nd.last_used = self._tick
            self._attach(node, nd)
            refs.append(nd)
            self.inserted += 1
            node = nd

    def release_slot(self, slot: int, stream=None, upto: int = 0):
        """Eviction hook: donate the slot's remaining full pages (prompt
        tail + generated tokens), drop its node references, then release
        the slot's pages — so the pages freed here are admissible in the
        same engine window."""
        if stream is not None and int(upto) >= self.page_size:
            self.donate(slot, stream, upto)
        for nd in self.slot_nodes.pop(slot, []):
            nd.ref -= 1
            assert nd.ref >= 0, nd.name
        self.kv.free_slot(slot)

    # -- eviction under pool pressure ----------------------------------
    def _nodes(self, node=None):
        node = node or self.root
        for lst in node.children.values():
            for c in lst:
                yield c
                yield from self._nodes(c)

    def _child(self, node: RadixNode, chunk) -> Optional[RadixNode]:
        for c in node.children.get(chunk[0], []):
            if c.tokens == chunk:
                return c
        return None

    def _attach(self, node: RadixNode, nd: RadixNode):
        node.children.setdefault(nd.tokens[0], []).append(nd)

    def _path_key(self, nd: RadixNode) -> tuple:
        """Cold-tier key: the node's full root->leaf token path (the only
        stable identity a re-attached node can be matched back by)."""
        chunks = []
        while nd is not None and nd.parent is not None:
            chunks.append(nd.tokens)
            nd = nd.parent
        return tuple(t for chunk in reversed(chunks) for t in chunk)

    def _evict(self, nd: RadixNode, count: bool = True):
        lst = nd.parent.children[nd.tokens[0]]
        lst.remove(nd)
        if not lst:
            del nd.parent.children[nd.tokens[0]]
        if count and self.cold_store is not None:
            # cold tier: the leaf's page survives eviction on the host
            # (quantized per the pool's cold_dtype) instead of being
            # discarded — fault_cold re-adopts it on the next matching
            # admission, saving the suffix's re-prefill. A host-tier write
            # fault degrades to the discard-on-evict behaviour (the page is
            # still released; the content re-prefills from tokens later) —
            # eviction must complete either way.
            try:
                self.cold_store(self._path_key(nd), nd.page)
                self.cold_stores += 1
            except HostTierFault:
                self.cold_store_failures += 1
        self.kv.tree_release_page(nd.page, nd.name)
        if count:
            self.evictions += 1

    def release_tree(self):
        """Teardown counterpart of ``PagedKVCache.release()``: return every
        tree-owned page (and its arena node group) to the pool. Slots must
        be drained first — a referenced node means a live page table still
        maps its page."""
        while True:
            leaves = [nd for nd in self._nodes() if nd.is_leaf()]
            if not leaves:
                break
            for nd in leaves:
                assert nd.ref == 0, f"{nd.name} still referenced at teardown"
                self._evict(nd, count=False)

    def evict_until(self, need_pages: int) -> bool:
        """LRU-evict zero-ref leaves until ``need_pages`` are admissible.
        Returns False when the remaining tree is fully referenced."""
        while not self.kv.can_admit_pages(need_pages):
            victim = None
            for nd in self._nodes():
                if nd.ref == 0 and nd.is_leaf() and (
                        victim is None or nd.last_used < victim.last_used):
                    victim = nd
            if victim is None:
                return False
            self._evict(victim)
        return True

    def fault_cold(self, tokens) -> int:
        """Re-adopt cold-tier pages matching this prompt before admission
        planning: walk to the tree's frontier and, while the next full-page
        chunk's root->leaf key is resident on the host and a device page is
        admissible, adopt a fresh tree page and fault the host content into
        it. Returns pages faulted (0 when the frontier diverges inside a
        page — nothing below a partial match is usable)."""
        if self.cold_loader is None or self.kv is None:
            return 0
        toks = tuple(int(t) for t in tokens)
        ps = self.page_size
        path, i = self._walk(toks)
        if i % ps:
            return 0
        node = path[-1] if path else self.root
        faulted = 0
        self._tick += 1
        while i + ps <= len(toks):
            key = toks[:i + ps]
            if not self.cold_has(key) or not self.kv.can_admit_pages(1):
                break
            name = f"{self.kv.name}:px{self._next_id}"
            self._next_id += 1
            page = self.kv.tree_adopt_page(name)
            try:
                self.cold_loader(key, page)
            except HostTierFault:
                # read fault or checksum-caught corruption: undo the
                # adoption (page + arena group back to the pool) and stop —
                # admission proceeds without the cold chunk and the suffix
                # re-prefills from tokens (never from a bad cold page)
                self.kv.tree_release_page(page, name)
                self.cold_fault_failures += 1
                break
            nd = RadixNode(toks[i:i + ps], page, node, name)
            nd.last_used = self._tick
            self._attach(node, nd)
            node = nd
            i += ps
            faulted += 1
            self.cold_faults += 1
        return faulted

    # -- tidal recolor / pinning ---------------------------------------
    def recolor(self, new_channels: Sequence[int]) -> dict:
        """Resplit mapping for the tree's *unreferenced* node groups.
        Referenced groups are pinned (see :meth:`pinned_names`): migrating
        them would move a page out from under a live page table."""
        chans = tuple(new_channels)
        return {nd.name: chans for nd in self._nodes() if nd.ref == 0}

    def pinned_names(self) -> List[str]:
        return [nd.name for nd in self._nodes() if nd.ref > 0]

    def drain_recolor(self) -> dict:
        """Mapping for previously pinned node groups whose references have
        since dropped and whose arena placement still has the old color."""
        arena = self.kv.arena
        if arena is None:
            return {}
        want = tuple(self.kv.channels)
        out = {}
        for nd in self._nodes():
            if nd.ref > 0:
                continue
            a = arena.allocations.get(nd.name)
            if a is not None and tuple(a.channels) != want:
                out[nd.name] = want
        return out

    # -- estimator mode / stats ----------------------------------------
    def insert_tokens(self, tokens):
        """Token-only insert (estimator mode: no pages, no kv)."""
        toks = tuple(int(t) for t in tokens)
        ps = self.page_size
        node = self.root
        self._tick += 1
        for j in range(len(toks) // ps):
            chunk = toks[j * ps:(j + 1) * ps]
            nxt = self._child(node, chunk)
            if nxt is None:
                nxt = RadixNode(chunk, None, node)
                self._attach(node, nxt)
                self.inserted += 1
            nxt.last_used = self._tick
            node = nxt

    def stats(self) -> dict:
        nodes = list(self._nodes())
        out = {
            "hits": self.hits,
            "misses": self.misses,
            "hit_tokens": self.hit_tokens,
            "prompt_tokens": self.prompt_tokens,
            "hit_rate": (self.hit_tokens / self.prompt_tokens
                         if self.prompt_tokens else 0.0),
            "nodes": len(nodes),
            "referenced_nodes": sum(nd.ref > 0 for nd in nodes),
            "evictions": self.evictions,
            "inserted": self.inserted,
        }
        if self.cold_store is not None:
            out["cold_stores"] = self.cold_stores
            out["cold_faults"] = self.cold_faults
            if self.cold_store_failures or self.cold_fault_failures:
                out["cold_failures"] = {
                    "store": self.cold_store_failures,
                    "load": self.cold_fault_failures}
        if self.kv is not None:
            out["cow_forks"] = self.kv.cow_forks
        return out
