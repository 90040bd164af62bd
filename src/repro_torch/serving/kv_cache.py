"""Paged KV cache for the serving engine (vLLM-style paging), in PyTorch.

The KV cache of a tenant's whole decode-slot pool lives in one shared *page
pool* per layer ([n_pages, Hkv, page_size, Dh] for GQA) instead of per-slot
whole rows of ``max_seq`` tokens. Each slot addresses the pool through a
page table ([n_slots, P] int32); a prefill chunk writes its tokens' page
entries, decode appends one (page, offset) entry per row — O(tokens)
traffic, never a full-cache rewrite.

The host-side metadata (page tables, free lists, refcounts) is the
reference's numpy bookkeeping, copied as it is. The device side is torch:
the pools (``init_pools``), the page table as an int32 tensor on the
engine's device (``device_page_table``), and the copy-on-write page copy
(``fork_cow``). SGDRC coloring (``arena=``, pages carved from a
ColoredArena's channel set) is a later slice: passing an arena raises
``NotImplementedError``, and the arena branches below stay inert until then.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..models import transformer as tf
from ..models.common import dt


class OutOfColoredMemory(RuntimeError):
    """The pool (or, with coloring, the class's colored bytes) cannot hold
    the pages a request needs."""


def kv_token_bytes(cfg: ModelConfig, dtype_bytes: float) -> float:
    """KV-cache bytes one token occupies in ONE attention layer
    (``repro.core.costmodel.kv_token_bytes``): MLA caches the compressed
    latent (R + rope), GQA caches k + v heads."""
    if cfg.attn_type == "mla":
        return (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim) * dtype_bytes
    return 2 * cfg.num_kv_heads * cfg.head_dim * dtype_bytes


def kv_bytes_per_token(cfg: ModelConfig, dtype_bytes: Optional[int] = None
                       ) -> int:
    """KV-cache bytes one token occupies across all layers (GQA: 2·Hkv·Dh
    per attention layer; MLA: R + rope latent floats per layer; hybrid
    models add one shared-attention cache per layer period)."""
    if dtype_bytes is None:
        dtype_bytes = torch.empty((), dtype=dt(cfg.activation_dtype)) \
            .element_size()
    tok = kv_token_bytes(cfg, dtype_bytes)
    n_attn = sum(1 for kind in cfg.pattern
                 if kind.replace("_shared", "") in ("global", "local"))
    total = n_attn * tok
    if any(k.endswith("_shared") for k in cfg.layer_pattern):
        # init_cache allocates ONE shared KV cache per layer period
        n_periods = ((cfg.num_layers - cfg.n_prefix)
                     // max(len(cfg.layer_pattern), 1))
        total += n_periods * tok
    return int(total)


class PagedKVCache:
    """Page-table bookkeeping for one tenant's slot pool.

    Parameters:
      cfg         model whose KV the pool holds (must be ``tf.pageable``)
      n_slots     decode batch width (page-table rows)
      max_seq     per-slot window cap: P = ceil(max_seq / page_size)
      page_size   tokens per page
      n_pages     pool size; default gives the same capacity as ``n_slots``
                  dense rows (the win is *allocation* granularity). With an
                  arena attached the pool is capped by the channel set's
                  free colored bytes.
      arena       optional ColoredArena; page groups become named colored
                  allocations (alloc at admit / release at evict)
      channels    the tenant class's channel set within the arena
      cap_channels  channel set used only for the construction-time pool cap
                  (default: ``channels``). An online controller passes the
                  full channel range here so the device pool is sized for
                  the tidal maximum — admission still re-checks the *live*
                  colored bytes of ``channels``, which :meth:`recolor`
                  moves at plan transitions.
      sharing     enable page refcounts + copy-on-write sharing (the prefix
                  cache's contract): pages may be mapped into several slots'
                  page tables (:meth:`share`), a write into a shared page
                  forks it first (:meth:`fork_cow`), and arena accounting
                  moves to one group per page so a page's bytes can be
                  renamed from a slot's group to a radix-tree node's group
                  when the slot donates it.

    Refcount invariant (sharing mode): ``page_ref[p]`` = number of page
    tables mapping ``p`` plus one if a radix-tree node owns ``p``. A page
    returns to the free list only at refcount zero; it is writable by a slot
    only while that slot is its sole owner (refcount 1 and slot-owned).
    """

    def __init__(self, cfg: ModelConfig, n_slots: int, max_seq: int,
                 page_size: int, *, n_pages: Optional[int] = None,
                 dtype=None, arena=None,
                 channels: Optional[Sequence[int]] = None, name: str = "kv",
                 cap_channels: Optional[Sequence[int]] = None,
                 sharing: bool = False, device="cuda"):
        assert tf.pageable(cfg), f"{cfg.name} is not pageable"
        if arena is not None:
            raise NotImplementedError(
                "colored page pools (arena=) are not ported yet")
        self.device = torch.device(device)
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.page_size = page_size
        self.pages_per_slot = -(-max_seq // page_size)
        dtype = dtype or dt(cfg.activation_dtype)
        self.bytes_per_page = (
            kv_bytes_per_token(cfg, torch.empty((), dtype=dtype)
                               .element_size()) * page_size)
        self.arena, self.channels, self.name = arena, channels, name
        if arena is not None:
            cap_src = channels if cap_channels is None else cap_channels
            cap = (arena.free_pages(cap_src) * arena.granularity
                   // max(self.bytes_per_page, 1))
            n_pages = min(n_pages, cap) if n_pages else cap
        elif n_pages is None:
            n_pages = n_slots * self.pages_per_slot
        assert n_pages > 0, "arena too small for a single KV page"
        self.n_pages = n_pages
        # sentinel n_pages = unmapped: positive out-of-bounds, so device
        # scatters drop the write (negative indices would wrap)
        self.page_table = np.full((n_slots, self.pages_per_slot), n_pages,
                                  np.int32)
        self.slot_pages: List[List[int]] = [[] for _ in range(n_slots)]
        self.free_list: List[int] = list(range(n_pages))[::-1]
        self._pt_dev = None          # device copy, refreshed on alloc/free
        # -- sharing state (prefix cache contract) ---------------------
        self.sharing = sharing
        self.page_ref = np.zeros(n_pages, np.int32)
        # per slot: tree-owned pages mapped read-only, the set of page-table
        # indices that are tree-owned (not writable), and pre-reserved
        # copy-on-write destination pages
        self.slot_shared: List[List[int]] = [[] for _ in range(n_slots)]
        self.slot_shared_idx: List[set] = [set() for _ in range(n_slots)]
        self.slot_reserve: List[List[int]] = [[] for _ in range(n_slots)]
        self.cow_forks = 0
        # pages appended by grow_slot in non-sharing arena mode carry their
        # own per-page arena groups (the slot's base group was sized at
        # admission and can't be extended in place)
        self.slot_grown: List[List[int]] = [[] for _ in range(n_slots)]
        # chaos plane: transient allocation-failure injection. The hook is
        # queried at the *call sites that start new work* (scheduler
        # admission, engine growth pre-pass) — deliberately NOT inside
        # can_admit_pages, which PrefixCache.evict_until loops on: a hard
        # failure there would flush the whole prefix tree chasing pages an
        # injected fault withholds. Deferral, not eviction, is the
        # graceful-degradation contract for alloc faults.
        self.fault_hook = None           # () -> bool: alloc window active?
        self.alloc_faults = 0

    def alloc_fault(self) -> bool:
        """True while an injected allocation-failure window is active —
        callers defer admissions/growth for the window (counted)."""
        if self.fault_hook is not None and self.fault_hook():
            self.alloc_faults += 1
            return True
        return False

    def _slot_group(self, slot: int, page: int) -> str:
        """Arena group of one slot-owned page (sharing mode: one group per
        page, so donation can ``rename`` it to a tree node's group)."""
        return f"{self.name}:s{slot}:p{page}"

    # -- capacity ------------------------------------------------------
    def pages_for(self, tokens: int) -> int:
        return -(-min(tokens, self.max_seq) // self.page_size)

    @property
    def free_pages(self) -> int:
        return len(self.free_list)

    @property
    def used_pages(self) -> int:
        return self.n_pages - len(self.free_list)

    def _arena_pages(self, n: int) -> int:
        """Colored arena pages n KV pages occupy (per-page groups round each
        page up to the coloring granularity)."""
        g = self.arena.granularity
        if self.sharing:
            return n * -(-self.bytes_per_page // g)
        return -(-n * self.bytes_per_page // g)

    def can_admit_pages(self, n: int) -> bool:
        if n > len(self.free_list):
            return False
        if self.arena is not None:
            # the arena is shared with other tenants: re-check colored bytes
            return self.arena.free_pages(self.channels) >= self._arena_pages(n)
        return True

    def can_admit(self, tokens: int) -> bool:
        return self.can_admit_pages(self.pages_for(tokens))

    # -- alloc / free at step boundaries -------------------------------
    def _alloc_pages(self, slot: int, n: int) -> List[int]:
        if n > len(self.free_list):
            raise OutOfColoredMemory(f"{self.name}: need {n} KV pages")
        if self.arena is not None:
            if self.arena.free_pages(self.channels) < self._arena_pages(n):
                raise OutOfColoredMemory(
                    f"{self.name}: need {n} colored KV pages")
            if not self.sharing:
                self.arena.alloc(f"{self.name}:s{slot}",
                                 n * self.bytes_per_page, self.channels)
        pages = [self.free_list.pop() for _ in range(n)]
        for p in pages:
            self.page_ref[p] = 1
            if self.arena is not None and self.sharing:
                self.arena.alloc(self._slot_group(slot, p),
                                 self.bytes_per_page, self.channels)
        return pages

    def alloc_slot(self, slot: int, tokens: int) -> List[int]:
        """Reserve pages for a request's full extent (prompt + max_new,
        capped at max_seq) and map them into the slot's page table."""
        n = self.pages_for(tokens)
        assert not self.slot_pages[slot] and not self.slot_shared[slot], \
            f"slot {slot} already mapped"
        pages = self._alloc_pages(slot, n)
        self.slot_pages[slot] = pages
        self.page_table[slot, :n] = pages
        self._pt_dev = None
        return pages

    # -- dynamic growth (KV hierarchy tier 1) --------------------------
    def mapped_count(self, slot: int) -> int:
        """Mapped page-table entries for ``slot`` (shared + private)."""
        return int(np.sum(self.page_table[slot] < self.n_pages))

    def needs_grow(self, slot: int, pos: int) -> bool:
        """True when a token write at ``pos`` would land on an unmapped
        page-table entry — the caller must :meth:`grow_slot` first (after
        making room: evict a prefix leaf, swap out, or preempt)."""
        j = pos // self.page_size
        return j < self.pages_per_slot and \
            int(self.page_table[slot, j]) >= self.n_pages

    def grow_slot(self, slot: int) -> int:
        """Append one private page at the slot's first unmapped table entry
        (decode crossed a page boundary under growth-mode admission, which
        only reserved the prompt's pages)."""
        j = self.mapped_count(slot)
        assert j < self.pages_per_slot, f"slot {slot} already at max extent"
        if not self.free_list:
            raise OutOfColoredMemory(f"{self.name}: no free page to grow")
        if self.arena is not None:
            if self.arena.free_pages(self.channels) < self._arena_pages(1):
                raise OutOfColoredMemory(
                    f"{self.name}: no colored page to grow")
        page = self.free_list.pop()
        self.page_ref[page] = 1
        if self.arena is not None:
            self.arena.alloc(self._slot_group(slot, page),
                             self.bytes_per_page, self.channels)
            if not self.sharing:
                self.slot_grown[slot].append(page)
        self.slot_pages[slot].append(page)
        self.page_table[slot, j] = page
        self._pt_dev = None
        return page

    def alloc_slot_pages(self, slot: int, n: int) -> List[int]:
        """Map exactly ``n`` private pages into an empty slot (swap-in
        restore: the faulting request's page-group size is known in pages,
        not tokens)."""
        assert not self.slot_pages[slot] and not self.slot_shared[slot], \
            f"slot {slot} already mapped"
        pages = self._alloc_pages(slot, n)
        self.slot_pages[slot] = pages
        self.page_table[slot, :n] = pages
        self._pt_dev = None
        return pages

    def tree_adopt_page(self, node_group: str) -> int:
        """Allocate one page directly owned by a radix-tree node (a cold
        prefix fault restores an evicted leaf's page from the host tier
        without a slot intermediary). Inverse of :meth:`tree_release_page`.
        Sharing mode only."""
        assert self.sharing
        if not self.free_list:
            raise OutOfColoredMemory(f"{self.name}: no page for cold fault")
        if self.arena is not None:
            if self.arena.free_pages(self.channels) < self._arena_pages(1):
                raise OutOfColoredMemory(
                    f"{self.name}: no colored page for cold fault")
            self.arena.alloc(node_group, self.bytes_per_page, self.channels)
        page = self.free_list.pop()
        self.page_ref[page] = 1
        return page

    # -- sharing primitives (driven by serving.prefix_cache) -----------
    def share(self, slot: int, pages: Sequence[int]):
        """Map tree-owned pages read-only into the slot's leading page-table
        entries (a prefix-cache hit). Each mapping takes a reference."""
        assert not self.slot_pages[slot] and not self.slot_shared[slot], \
            f"slot {slot} already mapped"
        k = len(pages)
        if k == 0:
            return
        self.page_table[slot, :k] = pages
        for p in pages:
            self.page_ref[p] += 1
        self.slot_shared[slot] = list(pages)
        self.slot_shared_idx[slot] = set(range(k))
        self._pt_dev = None

    def reserve(self, slot: int, n: int):
        """Pre-reserve copy-on-write destination pages for the writes this
        admission will make into shared pages (predicted at admission, so a
        later fork can never fail on an emptied pool)."""
        if n > 0:
            self.slot_reserve[slot] = self._alloc_pages(slot, n)

    def alloc_suffix(self, slot: int, tokens: int) -> List[int]:
        """Allocate private pages for the uncached tail of a request whose
        prefix is mapped via :meth:`share` (partial-hit admission: strictly
        fewer fresh pages than a cold request needs)."""
        n_total = self.pages_for(tokens)
        k = len(self.slot_shared[slot])
        n_new = n_total - k
        assert n_new >= 0, (n_total, k)
        pages = self._alloc_pages(slot, n_new)
        self.slot_pages[slot] = pages
        self.page_table[slot, k:n_total] = pages
        self._pt_dev = None
        return pages

    def needs_fork(self, slot: int, pos: int) -> bool:
        """True when a token write at ``pos`` would mutate a tree-owned
        (shared) page — the caller must :meth:`fork_cow` first."""
        return (pos // self.page_size) in self.slot_shared_idx[slot]

    def fork_cow(self, pools, slot: int, j: int):
        """Copy-on-write fork of the slot's ``j``-th page-table entry: the
        shared page's device contents are copied into a private page (from
        the slot's admission reserve), the table is remapped, and the shared
        page loses this slot's reference. Returns the updated pools."""
        src = int(self.page_table[slot, j])
        if self.slot_reserve[slot]:
            dst = self.slot_reserve[slot].pop()
        else:                               # safety net: unpredicted fork
            dst = self._alloc_pages(slot, 1)[0]
        _copy_page_tree(pools, src, dst)
        self.page_ref[src] -= 1
        assert self.page_ref[src] >= 1, "shared page lost its tree owner"
        self.slot_shared[slot].remove(src)
        self.slot_shared_idx[slot].discard(j)
        self.slot_pages[slot].append(dst)
        self.page_table[slot, j] = dst
        self._pt_dev = None
        self.cow_forks += 1
        return pools

    def transfer_to_tree(self, slot: int, j: int, node_group: str) -> int:
        """Donate the slot-owned page at table index ``j`` to a radix-tree
        node: the tree takes its own reference and the page's arena bytes
        are renamed from the slot's group to ``node_group``. The slot keeps
        its (now read-only) mapping until eviction. Returns the page id."""
        page = int(self.page_table[slot, j])
        self.slot_pages[slot].remove(page)
        self.slot_shared[slot].append(page)
        self.slot_shared_idx[slot].add(j)
        self.page_ref[page] += 1
        if self.arena is not None:
            self.arena.rename(self._slot_group(slot, page), node_group)
        return page

    def tree_release_page(self, page: int, node_group: str):
        """Prefix-cache eviction of a zero-ref node: drop the tree's
        reference and return the page to the pool + arena."""
        self.page_ref[page] -= 1
        assert self.page_ref[page] == 0, \
            f"evicting page {page} still referenced by a live page table"
        self.free_list.append(page)
        if self.arena is not None:
            self.arena.release(node_group)

    def free_slot(self, slot: int):
        own = self.slot_pages[slot] + self.slot_reserve[slot]
        shared = self.slot_shared[slot]
        if not own and not shared:
            return
        for p in shared:
            self.page_ref[p] -= 1        # the tree keeps its own reference
            assert self.page_ref[p] >= 1
        for p in own:
            self.page_ref[p] -= 1
            assert self.page_ref[p] == 0
            self.free_list.append(p)
            if self.arena is not None and self.sharing:
                self.arena.release(self._slot_group(slot, p))
        if self.arena is not None and not self.sharing:
            for p in self.slot_grown[slot]:
                self.arena.release(self._slot_group(slot, p))
            if len(self.slot_pages[slot]) > len(self.slot_grown[slot]):
                self.arena.release(f"{self.name}:s{slot}")
        self.slot_grown[slot] = []
        self.slot_pages[slot] = []
        self.slot_shared[slot] = []
        self.slot_shared_idx[slot] = set()
        self.slot_reserve[slot] = []
        self.page_table[slot, :] = self.n_pages
        self._pt_dev = None

    def release(self):
        """Return every live slot page group to the arena (tenant
        teardown). Sharing mode: drain the slots first, then call the
        prefix cache's ``release_tree()`` for the tree-owned pages and
        their ``:px`` arena groups — this method only drops the slots'
        references."""
        for slot in range(self.n_slots):
            self.free_slot(slot)

    def recolor(self, new_channels: Sequence[int]) -> dict:
        """Bimodal-tensor switch: rebind future page-group allocations to
        ``new_channels`` and return the ``{arena_name: new_channels}``
        mapping for the *live* groups, for the caller to feed into one
        :meth:`~repro.core.coloring.allocator.ColoredArena.resplit` batch
        (the engine merges every tenant's mapping into a single arena
        migration per plan transition). Device pools and page tables are
        untouched — tokens are unaffected by a mid-run recolor. Sharing
        mode enumerates the per-page slot groups; tree-node groups are the
        prefix cache's to recolor (it pins referenced ones)."""
        self.channels = tuple(new_channels)
        if self.arena is None:
            return {}
        if self.sharing:
            return {self._slot_group(s, p): self.channels
                    for s in range(self.n_slots)
                    for p in self.slot_pages[s] + self.slot_reserve[s]}
        out = {f"{self.name}:s{s}": self.channels
               for s in range(self.n_slots)
               if len(self.slot_pages[s]) > len(self.slot_grown[s])}
        out.update({self._slot_group(s, p): self.channels
                    for s in range(self.n_slots)
                    for p in self.slot_grown[s]})
        return out

    # -- device-side structures ----------------------------------------
    def init_pools(self, dtype=None):
        return tf.init_paged_cache(self.cfg, self.n_pages, self.page_size,
                                   dtype, device=self.device)

    def device_page_table(self):
        # cached between admit/evict boundaries: pure-decode stretches must
        # not pay a host->device transfer per step for an unchanged table
        if self._pt_dev is None:
            self._pt_dev = torch.from_numpy(self.page_table.copy()).to(
                self.device)
        return self._pt_dev


def _copy_page_tree(pools, src: int, dst: int):
    """Device-side page copy for a copy-on-write fork: every pool leaf's
    ``src`` page is duplicated onto its ``dst`` page, in place."""
    for pp in pools.get("prefix", []):
        for leaf in pp.values():
            _copy_page(leaf, src=src, dst=dst, batch_axis=0)
    for layer in pools["layers"].values():
        for leaf in layer.values():
            _copy_page(leaf, src=src, dst=dst, batch_axis=1)
    return pools


def _copy_page(pool, *, src, dst, batch_axis):
    ix = (slice(None),) * batch_axis
    pool[ix + (dst,)] = pool[ix + (src,)]
