"""Simulated VRAM timing device for the reverse-engineering probes.

Models the memory-hierarchy observables the paper's Algo 1-3 rely on:
  * per-channel L2 slices (set-associative, LRU) -> cacheline-conflict probing
  * per-channel DRAM banks with open-row state   -> bank-conflict probing
  * read latency = f(L2 hit/miss, bank row hit/conflict) + measurement noise

The hidden address->channel hash comes from ``hashmaps`` — the probes must
recover it from latencies alone (ground truth is only used for validation).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

LINE = 256               # bytes per L2 cacheline
L2_HIT = 220.0           # cycles
L2_MISS = 470.0
BANK_CONFLICT = 260.0    # extra cycles for back-to-back same-bank row miss
CH_SERIAL = 130.0        # extra cycles for back-to-back misses on one channel
                         # (a VRAM channel has a single memory controller and
                         # serves one request at a time — §2.1/§2.3; this is
                         # the pairwise observable Algo 1 exploits)
NOISE = 8.0              # latency measurement noise (std, cycles)


@dataclass
class VRAMDevice:
    hash_model: object
    l2_bytes_per_channel: int = 64 * 1024
    assoc: int = 4
    banks_per_channel: int = 8
    row_bytes: int = 4096
    seed: int = 0

    def __post_init__(self):
        self.n_ch = self.hash_model.num_channels
        self.sets = self.l2_bytes_per_channel // (LINE * self.assoc)
        self.tags = np.full((self.n_ch, self.sets, self.assoc), -1, np.int64)
        self.lru = np.zeros((self.n_ch, self.sets, self.assoc), np.int64)
        self.open_row = np.full((self.n_ch, self.banks_per_channel), -1, np.int64)
        self.last_bank = None       # (ch, bank) of the immediately previous miss
        self.last_channel = None    # channel of the immediately previous miss
        self.rng = np.random.default_rng(self.seed)
        self.clock = 0
        self.reads = 0

    # -- address decomposition ------------------------------------------------
    def _decompose(self, addr: int):
        ch = int(self.hash_model.channel_of(np.asarray([addr]))[0])
        line = addr // LINE
        st = int(line % self.sets)
        tag = int(line)
        bank = int((addr // self.row_bytes) % self.banks_per_channel)
        row = int(addr // (self.row_bytes * self.banks_per_channel))
        return ch, st, tag, bank, row

    def flush(self):
        self.tags[:] = -1
        self.open_row[:] = -1
        self.last_bank = None
        self.last_channel = None

    def read(self, addr: int) -> float:
        """Simulate one dependent read; returns measured latency (cycles)."""
        self.reads += 1
        self.clock += 1
        ch, st, tag, bank, row = self._decompose(addr)
        ways = self.tags[ch, st]
        hit = np.nonzero(ways == tag)[0]
        lat = L2_HIT
        if hit.size:
            self.lru[ch, st, hit[0]] = self.clock
            self.last_bank = None
            self.last_channel = None
        else:
            lat = L2_MISS
            # back-to-back misses on the same channel serialize at the
            # channel's memory controller
            if self.last_channel == ch:
                lat += CH_SERIAL
            # DRAM access: row conflict if bank open on another row, and
            # back-to-back same-bank accesses serialize further
            if self.open_row[ch, bank] not in (-1, row):
                lat += BANK_CONFLICT * 0.5
            if self.last_bank == (ch, bank) and self.open_row[ch, bank] != row:
                lat += BANK_CONFLICT
            self.open_row[ch, bank] = row
            self.last_bank = (ch, bank)
            self.last_channel = ch
            victim = int(np.argmin(self.lru[ch, st]))
            self.tags[ch, st, victim] = tag
            self.lru[ch, st, victim] = self.clock
        return lat + float(self.rng.normal(0.0, NOISE))

    def read_chain(self, addrs) -> float:
        return float(sum(self.read(int(a)) for a in addrs))
