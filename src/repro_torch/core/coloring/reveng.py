"""Reverse-engineering the VRAM channel mapping from latency probes —
the paper's Algo 1 (DRAM/channel conflicts), Algo 2 (L2 cacheline conflicts),
and Algo 3 (channel marking), run against the simulated timing device.

Probe observables (see device_model):
  * Algo 1 — back-to-back L2 misses to the *same channel* serialize at that
    channel's memory controller (one DRAM request per cycle, §2.1), so a
    flushed pairwise read times measurably slower for same-channel pairs.
  * Algo 2 — addresses on the same channel AND same L2 set evict each other
    (used to discover the coloring granularity and minimal eviction sets).
  * Algo 3 — an address is marked with channel i if it conflicts (majority
    vote) with channel i's representative members.

Output: *measured* (address, channel-label) samples — labels are arbitrary
cluster ids with occasional timing-noise mislabels, exactly the data regime
in which the paper trains its MLP (§5.2).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .device_model import LINE, L2_HIT, L2_MISS, CH_SERIAL, VRAMDevice

MISS_THRESHOLD = (L2_HIT + L2_MISS) / 2.0
PAIR_THRESHOLD = 2 * L2_MISS + CH_SERIAL / 2.0


# ---------------------------------------------------------------------------
# Algo 1
# ---------------------------------------------------------------------------

def is_channel_conflicted(dev: VRAMDevice, a0: int, a1: int,
                          votes: int = 3) -> bool:
    """Algo 1: refresh L2, read the pair back-to-back, time it; majority."""
    hits = 0
    for _ in range(votes):
        dev.flush()
        if dev.read(a0) + dev.read(a1) > PAIR_THRESHOLD:
            hits += 1
    return hits * 2 > votes


# ---------------------------------------------------------------------------
# Algo 2
# ---------------------------------------------------------------------------

def is_cacheline_evicted(dev: VRAMDevice, addr: int, evict_set) -> bool:
    dev.flush()
    dev.read(addr)
    dev.read_chain(list(evict_set) * 2)
    return dev.read(addr) > MISS_THRESHOLD


def _reduce_eviction_set(dev, addr, batch):
    """Classic group-test reduction to a minimal eviction set."""
    cur = list(batch)
    i = 0
    while i < len(cur):
        trial = cur[:i] + cur[i + 1:]
        if is_cacheline_evicted(dev, addr, trial):
            cur = trial
        else:
            i += 1
    return cur


def find_cache_conflict_addrs(dev: VRAMDevice, addr: int, space: int,
                              need: int) -> list[int]:
    """Algo 2: same-set candidates, batch until eviction, then reduce."""
    stride = LINE * dev.sets                 # same-set stride
    out: list[int] = []
    cand = addr + stride
    batch: list[int] = []
    batch_size = 4 * dev.assoc * dev.n_ch // 2
    while len(out) < need and cand + stride <= space:
        batch.append(cand)
        cand += stride
        if len(batch) >= batch_size:
            if is_cacheline_evicted(dev, addr, batch):
                out.extend(_reduce_eviction_set(dev, addr, batch))
            batch = []
    return out[:need]


# ---------------------------------------------------------------------------
# Algo 3
# ---------------------------------------------------------------------------

def mark_channel(dev: VRAMDevice, addr: int, reps: list[list[int]],
                 votes: int = 3) -> int:
    """Identify addr's channel by pairwise conflict with representatives."""
    for ci, members in enumerate(reps):
        hits = 0
        for m in members[:votes]:
            dev.flush()
            if dev.read(m) + dev.read(addr) > PAIR_THRESHOLD:
                hits += 1
        if hits * 2 > min(votes, len(members)):
            return ci
    return -1


def build_channel_representatives(dev: VRAMDevice, space: int,
                                  per_channel: int = 4,
                                  max_misses: int = 96) -> list[list[int]]:
    """Discover one representative member-set per channel (no ground truth):
    walk pages; a page that matches no known channel seeds a new one, and its
    members are grown via Algo-1 pair tests."""
    gran = dev.hash_model.granularity
    reps: list[list[int]] = []
    page, misses = 0, 0
    while misses < max_misses and (page + 1) * gran < space:
        addr = page * gran
        if mark_channel(dev, addr, reps) == -1:
            members = [addr]
            cand_page = page + 1
            while (len(members) < per_channel
                   and (cand_page + 1) * gran < space):
                cand = cand_page * gran
                if is_channel_conflicted(dev, addr, cand):
                    members.append(cand)
                cand_page += 1
            reps.append(members)
            misses = 0
        else:
            misses += 1
        page += 7  # co-prime stride to sample across permutation blocks
    return reps


@dataclass
class RevEngResult:
    addrs: np.ndarray          # probed addresses
    labels: np.ndarray         # measured channel labels (cluster ids)
    true_channels: np.ndarray  # ground truth (validation only)
    label_accuracy: float      # consistency of labels vs ground truth
    num_channels_found: int


def collect_samples(dev: VRAMDevice, space: int, n_samples: int,
                    seed: int = 0, reps=None) -> RevEngResult:
    """Full pipeline: discover representatives, then label random pages."""
    rng = np.random.default_rng(seed)
    gran = dev.hash_model.granularity
    if reps is None:
        reps = build_channel_representatives(dev, space)
    n_pages = space // gran
    pages = rng.choice(n_pages, size=n_samples, replace=n_samples > n_pages)
    addrs = pages.astype(np.int64) * gran
    labels = np.array([mark_channel(dev, int(a), reps) for a in addrs])
    true = dev.hash_model.channel_of(addrs)
    return RevEngResult(addrs, labels, true,
                        _cluster_accuracy(labels, true), len(reps))


def measure_granularity(dev: VRAMDevice, base: int = 0,
                        max_bytes: int = 64 * 1024) -> int:
    """How many contiguous bytes share base's channel (paper: every
    contiguous 1 KiB belongs to one channel; runs of 2-8 KiB per GPU)."""
    step = 256
    run = step
    while run < max_bytes and is_channel_conflicted(dev, base, base + run):
        run += step
    return run


def _cluster_accuracy(labels, true) -> float:
    ok = 0
    for l in np.unique(labels):
        if l < 0:
            continue
        sel = labels == l
        vals, counts = np.unique(true[sel], return_counts=True)
        ok += counts.max()
    return ok / max(len(labels), 1)
