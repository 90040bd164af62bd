"""Telemetry plane: the tracer and windowed metrics, copied from
``repro.obs`` (pure Python). The SLO timeline is not ported yet."""
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry, pcts,
                      percentile)
from .schema import (EVENT_KINDS, PLAN_CAUSES, SchemaError, validate_event,
                     validate_events)
from .trace import DEFAULT_TRIGGERS, OFF, Tracer
from .export import to_jsonl, to_perfetto, write_jsonl, write_perfetto

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "pcts",
    "percentile", "EVENT_KINDS", "PLAN_CAUSES", "SchemaError",
    "validate_event", "validate_events", "DEFAULT_TRIGGERS", "OFF",
    "Tracer", "to_jsonl", "to_perfetto", "write_jsonl", "write_perfetto",
]
