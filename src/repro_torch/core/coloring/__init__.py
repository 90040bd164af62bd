"""VRAM channel coloring: the hash models and the colored arena whose shadow
page tables (SPTs) the ``spt_gather`` / ``spt_scatter`` kernels consume, and
which the serving engine's ``coloring=True`` path carves KV page groups
from.

``hashmaps`` and ``allocator`` are verbatim copies of the reference's
(numpy only). Its channel reverse engineering (``reveng``), simulated device
(``device_model``) and MLP hash fit (``mlp_fit``) are not ported.
"""
from .hashmaps import GPU_SPECS, PermutationHash, XorHash, gpu_hash_model
from .allocator import (Allocation, ColoredArena, OutOfColoredMemory,
                        split_channels)
