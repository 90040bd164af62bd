"""Colored arena allocator + shadow page tables (§5.3).

A flat device arena (one big buffer) is partitioned into pages of the
coloring granularity; each page's channel comes from the (fitted) hash model.
A tenant is bound to a channel set; its tensors are allocated on pages of
those channels only, and accessed through a shadow page table (SPT): a
logical-page -> arena-page indirection consumed by the SPT gather/scatter
kernels (repro.kernels.spt_gather). Mispredicted channel ids (the MLP's
<0.1%) merely place a page off-color — functionally harmless, which the
isolation benchmark quantifies.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np


@dataclass
class Allocation:
    name: str
    nbytes: int
    granularity: int
    spt: np.ndarray            # [n_pages] arena page indices (int32)
    channels: tuple

    @property
    def n_pages(self) -> int:
        return len(self.spt)


class OutOfColoredMemory(RuntimeError):
    pass


class ColoredArena:
    """Manages a flat arena of ``total_bytes`` split into granularity pages,
    with per-channel free lists."""

    def __init__(self, total_bytes: int, channel_of_page,
                 num_channels: int, granularity: int = 1024):
        self.total_bytes = total_bytes
        self.granularity = granularity
        self.num_channels = num_channels
        n_pages = total_bytes // granularity
        pages = np.arange(n_pages, dtype=np.int64)
        chan = np.asarray(channel_of_page(pages * granularity), np.int64)
        assert chan.shape == (n_pages,)
        self.page_channel = chan
        self.free: list[list[int]] = [
            list(np.nonzero(chan == c)[0][::-1]) for c in range(num_channels)]
        self.allocations: dict[str, Allocation] = {}
        self.last_resplit = {"pages": 0, "bytes": 0}

    # ------------------------------------------------------------------
    def free_pages(self, channels: Sequence[int]) -> int:
        return sum(len(self.free[c]) for c in channels)

    def alloc(self, name: str, nbytes: int,
              channels: Sequence[int]) -> Allocation:
        """Allocate nbytes striped round-robin across the channel set (to
        preserve intra-tenant bandwidth parallelism)."""
        assert name not in self.allocations, name
        n_pages = -(-nbytes // self.granularity)
        if self.free_pages(channels) < n_pages:
            raise OutOfColoredMemory(
                f"{name}: need {n_pages} pages on channels {tuple(channels)}")
        spt = np.empty(n_pages, np.int32)
        ci = 0
        chans = list(channels)
        for i in range(n_pages):
            for _ in range(len(chans)):
                c = chans[ci % len(chans)]
                ci += 1
                if self.free[c]:
                    spt[i] = self.free[c].pop()
                    break
        a = Allocation(name, nbytes, self.granularity, spt, tuple(channels))
        self.allocations[name] = a
        return a

    def release(self, name: str):
        a = self.allocations.pop(name)
        for pg in a.spt:
            self.free[self.page_channel[pg]].append(int(pg))

    def rename(self, old: str, new: str):
        """Transfer an allocation to a new owner name (pure bookkeeping —
        pages, SPT and channel binding are untouched). Used by the prefix
        cache to move a KV page's bytes from a slot's group to a radix-tree
        node's group when a finished request donates the page."""
        assert new not in self.allocations, new
        a = self.allocations.pop(old)
        a.name = new
        self.allocations[new] = a
        return a

    # ------------------------------------------------------------------
    def resplit(self, new_channels: dict, pinned: Sequence[str] = ()) -> dict:
        """Move the LS/BE channel split online (the tidal re-plan's
        bimodal-tensor switch): rebind each named allocation to its new
        channel set and migrate its off-color pages onto free pages of that
        set, updating the SPT in place. Pages are conserved — every move
        pops one free page and returns one — and the *device* copy of a
        migrated page is the caller's concern (the serving engine counts
        moved pages; its KV pools address pages through their own tables, so
        the arena migration is pure placement bookkeeping there).

        Migration is best-effort: a page with no free on-color destination
        stays put and keeps counting as an ``isolation_violations`` entry
        until a later resplit (or a release) frees room — that residue is
        the bounded snap-back debt BE pays after borrowing LS channels.
        Multiple passes let allocations shrink into space freed by others in
        the same resplit. Returns ``{name: pages_moved}``; names absent from
        the arena (e.g. a KV page group freed since the plan was drawn) are
        skipped, as are ``pinned`` names — page groups another page table
        still references (shared prefix-cache pages) must not be migrated
        out from under their readers; they stay put until unpinned and a
        later resplit drains them. ``self.last_resplit`` records the
        migration's traffic cost ({"pages", "bytes"}) so callers can charge
        moved bytes to the window's HBM budget instead of treating the
        bimodal switch as free."""
        skip = set(pinned)
        names = [n for n in new_channels
                 if n in self.allocations and n not in skip]
        for n in names:
            self.allocations[n].channels = tuple(new_channels[n])
        moved = dict.fromkeys(names, 0)
        for _ in range(max(len(names), 1)):
            progress = False
            for n in names:
                a = self.allocations[n]
                ci = 0
                for i in range(a.n_pages):
                    if self.page_channel[a.spt[i]] in a.channels:
                        continue
                    for _ in range(len(a.channels)):
                        c = a.channels[ci % len(a.channels)]
                        ci += 1
                        if self.free[c]:
                            old = int(a.spt[i])
                            a.spt[i] = self.free[c].pop()
                            self.free[self.page_channel[old]].append(old)
                            moved[n] += 1
                            progress = True
                            break
            if not progress:
                break
        n_moved = sum(moved.values())
        self.last_resplit = {"pages": n_moved,
                             "bytes": n_moved * self.granularity}
        return moved

    # ------------------------------------------------------------------
    def channel_histogram(self, alloc: Allocation) -> np.ndarray:
        return np.bincount(self.page_channel[alloc.spt],
                           minlength=self.num_channels)

    def isolation_violations(self, alloc: Allocation) -> int:
        """Pages that landed off-color (0 with a perfect hash model; a few
        with MLP mispredictions)."""
        ch = self.page_channel[alloc.spt]
        return int(np.sum(~np.isin(ch, alloc.channels)))


def split_channels(num_channels: int, ch_be: float) -> tuple[tuple, tuple]:
    """Paper §5.3: LS tenants get (1 - Ch_BE), BE tenants get Ch_BE of the
    channels."""
    n_be = max(1, int(round(num_channels * ch_be)))
    n_be = min(n_be, num_channels - 1)
    be = tuple(range(num_channels - n_be, num_channels))
    ls = tuple(range(num_channels - n_be))
    return ls, be
