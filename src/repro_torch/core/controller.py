"""The controller's resource plan (``repro.core.controller.ResourcePlan``).

Only the plan dataclass is ported: the serving engine reads ``sm_be`` (the
BE quantum share) and ``prefill_budget`` (BE prefill tokens per quantum).
The offline grid search and the online controller are later slices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class ResourcePlan:
    sm_be: float
    ch_be: float
    thres_dram: float
    ls_channels: tuple
    be_channels: tuple
    max_ls_inflation: float
    # BE prefill tokens per engine quantum (None = unthrottled): the
    # serving scheduler's chunked-prefill throttle, so a plan can slow BE
    # prompt processing — the co-location that inflates LS TBT — without
    # also cutting BE's SM share or decode cadence
    prefill_budget: Optional[int] = None
    # host-tier budget: max KV pages faulted back from the host per engine
    # quantum (None = the engine's own default). The swap_pcie op is
    # already class-charged, so capping BE swap-in bandwidth here lets a
    # tidal snap-back trade BE's host-fault traffic against ch_be instead
    # of letting a BE swap storm ride the shrunken channel split
    swap_quantum_pages: Optional[int] = None
