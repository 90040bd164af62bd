"""Ground-truth VRAM channel hash models for the simulated device.

Two families, mirroring the paper's reverse-engineering findings (§5.2, §A.1):
  * XorHash        — linear XOR of physical-address bits (GTX 1080 / Tesla
                     V100 style; only valid for power-of-two channel counts).
  * PermutationHash— nonlinear: the VRAM space is a sequence of permutation
                     blocks; within a block, 1 KiB pages cycle through a
                     channel permutation drawn (deterministically but
                     non-linearly) from a per-GPU permutation set (Tesla P40 /
                     RTX A2000 / A5500 style; arbitrary channel counts).

Both expose: num_channels, granularity (bytes), channel_of(addr).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np

KIB = 1024


@dataclass(frozen=True)
class XorHash:
    """channel bit b = XOR of addr bits in bit_masks[b]."""
    bit_masks: tuple          # tuple of int masks, one per channel bit
    granularity: int = KIB

    @property
    def num_channels(self) -> int:
        return 1 << len(self.bit_masks)

    def channel_of(self, addr) -> np.ndarray:
        addr = np.asarray(addr, np.int64) & ~(self.granularity - 1)
        ch = np.zeros_like(addr)
        for b, mask in enumerate(self.bit_masks):
            bits = addr & np.int64(mask)
            # parity of the masked bits
            par = np.zeros_like(addr)
            x = bits
            while np.any(x):
                par ^= x & 1
                x >>= 1
            ch |= (par & 1) << b
        return ch


@dataclass(frozen=True)
class PermutationHash:
    """Nonlinear permutation-block mapping, mirroring the structure the
    paper's reverse engineering exposes (Fig. 9 / Fig. 15 / §A.1.2):

      * the VRAM space is a sequence of power-of-2 *permutation blocks*
        (pages_per_block = group_size x contiguous 1 KiB pages);
      * channels form groups (P40: A-D / E-H / I-L; A2000: A-B / C-D / E-F);
        a block belongs to one group and cycles its channels in runs of
        `contiguous` pages following one of the group's permutations;
      * group and permutation selection are *modular* (hence NOT an XOR /
        linear function of address bits — the paper's key observation) over
        a bounded window of physical-address bits (Fig. 15 shows the hash
        consumes specific bit fields — which is also what makes the paper's
        offline MLP fit attainable at >99.9%).
    """
    num_channels: int
    group_size: int           # channels per group (P40: 4, A2000/A5500: 2)
    contiguous: int           # pages per channel run (P40: 4, A2000/5500: 2)
    granularity: int = KIB
    sel_bits: int = 6         # width of the bit window feeding the hash
    seed: int = 7

    @property
    def pages_per_block(self) -> int:
        return self.group_size * self.contiguous

    @property
    def n_groups(self) -> int:
        return self.num_channels // self.group_size

    def _perm_table(self) -> np.ndarray:
        perms = list(itertools.permutations(range(self.group_size)))
        rng = np.random.default_rng(self.seed)
        rng.shuffle(perms)
        return np.asarray(perms, np.int64)             # [g!, group_size]

    def _select(self, block):
        """Bounded-bit-field nonlinear (modular) selector: the hash consumes
        a fixed window of physical-address bits (Fig. 15) and mixes them with
        modular arithmetic — deterministic, non-XOR-linear, bounded-domain."""
        b = block.astype(np.int64)
        window = b & ((1 << self.sel_bits) - 1)
        group = (window * 5 + (window >> 2)) % self.n_groups
        table = self._perm_table()
        perm_idx = (window * 7 + 3 * (window >> 1)) % len(table)
        return group, perm_idx

    def channel_of(self, addr) -> np.ndarray:
        addr = np.asarray(addr, np.int64)
        page = addr // self.granularity
        ppb = self.pages_per_block
        block = page // ppb
        slot = page % ppb
        group, perm_idx = self._select(block)
        table = self._perm_table()                      # [n_perms, g]
        run = slot // self.contiguous
        within = table[perm_idx, run]
        return group * self.group_size + within


# ---------------------------------------------------------------------------
# per-GPU model catalogue (Tab. 1 / Tab. 4 / Tab. 7 of the paper)
# ---------------------------------------------------------------------------

def gpu_hash_model(gpu: str):
    if gpu == "tesla-v100":          # 32 channels, XOR-linear, 8 KiB contiguous
        masks = [0b1 << (10 + i) for i in range(5)]
        masks = [m | (1 << (20 + i)) | (1 << (26 + i)) for i, m in enumerate(masks)]
        return XorHash(bit_masks=tuple(masks))
    if gpu == "tesla-p40":           # 12 ch: 3 groups of 4, runs of 4 pages
        return PermutationHash(12, group_size=4, contiguous=4, seed=40)
    if gpu == "rtx-a2000":           # 6 ch: 3 groups of 2, runs of 2 pages
        return PermutationHash(6, group_size=2, contiguous=2, seed=20)
    if gpu == "rtx-a5500":           # 12 ch: 6 groups of 2, runs of 2 pages
        return PermutationHash(12, group_size=2, contiguous=2, seed=55)
    if gpu == "tpu-v5e-hbm":         # 16 pseudo-channels, XOR-style interleave
        masks = [(1 << (10 + i)) | (1 << (18 + i)) for i in range(4)]
        return XorHash(bit_masks=tuple(masks))
    raise KeyError(gpu)


GPU_SPECS = {
    #              #chan  L2_bytes   dram_bw_GBps  sms
    "tesla-p40":   (12,   3 << 20,   346.0,        30),
    "tesla-v100":  (32,   6 << 20,   897.0,        80),
    "rtx-a2000":   (6,    3 << 20,   360.0,        28),
    "rtx-a5500":   (12,   6 << 20,   768.0,        80),
    "tpu-v5e-hbm": (16,   128 << 20, 819.0,        1),
}
