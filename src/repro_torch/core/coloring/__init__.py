"""VRAM channel coloring (§5.2): the hash models; the simulated timing
device (``device_model``) and the channel reverse engineering against it
(``reveng``: Algo 1's pairwise channel conflicts, Algo 2's eviction sets,
Algo 3's channel marking, the coloring granularity); the MLP fit of the
hash from probed samples (``mlp_fit``, trained with torch on the CPU or the
card); and the colored arena whose shadow page tables (SPTs) the
``spt_gather`` / ``spt_scatter`` kernels consume, and which the serving
engine's ``coloring=True`` path carves KV page groups from.

``hashmaps``, ``allocator``, ``device_model`` and ``reveng`` are verbatim
copies of the reference's (numpy only), as is ``mlp_fit.page_bits``.
"""
from .hashmaps import GPU_SPECS, PermutationHash, XorHash, gpu_hash_model
from .device_model import VRAMDevice
from .reveng import (RevEngResult, build_channel_representatives,
                     collect_samples, find_cache_conflict_addrs,
                     is_cacheline_evicted, is_channel_conflicted,
                     mark_channel, measure_granularity)
from .mlp_fit import FitResult, fit_channel_hash, page_bits
from .allocator import (Allocation, ColoredArena, OutOfColoredMemory,
                        split_channels)
