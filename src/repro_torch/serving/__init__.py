from .engine import Request, ServingEngine
from .kv_cache import PagedKVCache, kv_bytes_per_token
from .scheduler import (Phase, PrefillChunk, QuantumReport,
                        TokenBudgetScheduler)
