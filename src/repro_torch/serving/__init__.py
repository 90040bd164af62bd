from .disagg import DisaggregatedEngine
from .engine import Request, ServingEngine
from .faults import (FAULT_KINDS, ColdPageCorrupt, FaultEvent, FaultPlane,
                     HostTierFault, safe_floor)
from .kv_cache import PagedKVCache, kv_bytes_per_token
from .prefix_cache import AdmissionPlan, PrefixCache, RadixNode
from .scheduler import (Phase, PrefillChunk, QuantumReport,
                        TokenBudgetScheduler)
from .swap import (HostSwapPool, dequantize_page, model_bytes,
                   page_swap_requests, pipelined_serve_time, quantize_page,
                   swap_requests)
