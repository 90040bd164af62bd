"""Telemetry plane: structured tracing on the virtual clock, windowed
metrics and SLO timelines, copied from ``repro.obs`` (pure Python).

See :mod:`.schema` for the event model and cause taxonomy, :mod:`.trace`
for the determinism contract and :mod:`.timeline` for violation
attribution."""
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry, pcts,
                      percentile)
from .schema import (EVENT_KINDS, PLAN_CAUSES, SchemaError, validate_event,
                     validate_events)
from .timeline import SLOTimeline
from .trace import DEFAULT_TRIGGERS, OFF, Tracer
from .export import to_jsonl, to_perfetto, write_jsonl, write_perfetto

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "pcts",
    "percentile", "EVENT_KINDS", "PLAN_CAUSES", "SchemaError",
    "validate_event", "validate_events", "SLOTimeline", "DEFAULT_TRIGGERS",
    "OFF", "Tracer", "to_jsonl", "to_perfetto", "write_jsonl",
    "write_perfetto",
]
