"""Event schema for the telemetry plane.

Every trace event is a flat dict with five required keys::

    {"t": float,      # virtual-clock timestamp (engine ticks or seconds)
     "ph": str,       # "B" span-begin | "E" span-end | "I" instant | "C" counter
     "kind": str,     # one of EVENT_KINDS below -- the typed channel
     "name": str,     # human label (phase name, fault kind, cause, metric, ...)
     "track": str,    # timeline row: device/class/link, e.g. "prefill/ls0/slot2"
     "args": dict}    # kind-specific payload (JSON-scalar values only)

The ``kind`` registry is closed: emitting or validating an unknown kind is an
error, which is what lets CI fail the build when a producer drifts from the
schema.  Each kind carries a verbosity level (``coarse`` < ``info`` <
``debug``) used by :class:`repro.obs.trace.Tracer` to filter at emit time,
and a set of required ``args`` keys checked by :func:`validate_event`.

Cause taxonomy for ``plan`` events (the ``name`` field):

``slo_guard``
    the controller forced load to 1.0 because windowed LS SLO attainment
    dropped below its floor;
``hysteresis``
    idle-patience expired and the controller relaxed one regime toward the
    lending end of the frontier;
``lending``
    a hysteresis relaxation that landed on frontier index 0 (the tidal
    lending plan -- BE borrows the full idle allocation);
``snap_back``
    load rose and the controller snapped directly to the tighter target
    regime (tightening is immediate, never one-step);
``watchdog``
    the engine's free-page watchdog overrode the controller with the safe
    plan;
``schedule``
    a time-triggered :class:`PlanSchedule` switch;
``initial`` / ``replan``
    first plan application, or a re-application with no controller-reported
    cause (e.g. an externally set plan);
``chunk_adapt``
    the ChunkGovernor retuned the prefill chunk size / BE prefill budget
    from the windowed LS TBT p99 (SLO-driven chunk sizing).

Run ``python -m repro.obs.schema trace.jsonl`` to validate an exported JSONL
stream line-by-line (exit 1 on the first invalid event).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

PHASES = ("B", "E", "I", "C")

LEVELS: Dict[str, int] = {"off": -1, "coarse": 0, "info": 1, "debug": 2}

#: kind -> (verbosity level, allowed phases, required args keys)
EVENT_KINDS: Dict[str, Tuple[str, Tuple[str, ...], Tuple[str, ...]]] = {
    # control plane -----------------------------------------------------
    "plan":      ("coarse", ("I",), ("sm_be", "ch_be")),
    "fault":     ("coarse", ("I",), ("target",)),
    "recovery":  ("coarse", ("I",), ()),
    "violation": ("coarse", ("I",), ("rid", "tenant")),
    "lending":   ("coarse", ("I",), ()),
    # request lifecycle -------------------------------------------------
    "request":   ("info", ("B", "E", "I"), ()),
    "phase":     ("info", ("B", "E"), ("rid",)),
    "quantum":   ("info", ("I",), ("tenant", "decode_tokens",
                                   "prefill_tokens")),
    "swap":      ("info", ("I",), ("bytes", "direction")),
    # sub-chunk preemption: "abort" (BE tiles abandoned at a tile
    # boundary, LS admitted in the same quantum) / "resume" (the aborted
    # request's next chunk — a smaller chunk, bit-equal tokens)
    "preempt":   ("info", ("I",), ("tenant", "rid")),
    "flow":      ("info", ("I",), ("src", "dst", "bytes", "t_start",
                                   "t_end")),
    "gauge":     ("info", ("C",), ("value",)),
    # micro-level (sim backend) ----------------------------------------
    "kernel":    ("debug", ("I",), ("tenant",)),
    "chunk":     ("debug", ("I",), ("rid", "start", "len")),
    "counter":   ("debug", ("C",), ("value",)),
}

#: plan-transition causes (documented above; validated for plan events)
PLAN_CAUSES = ("slo_guard", "hysteresis", "lending", "snap_back",
               "watchdog", "schedule", "initial", "replan", "chunk_adapt")

REQUIRED_KEYS = ("t", "ph", "kind", "name", "track", "args")


class SchemaError(ValueError):
    pass


def kind_level(kind: str) -> int:
    try:
        return LEVELS[EVENT_KINDS[kind][0]]
    except KeyError:
        raise SchemaError(f"unknown event kind {kind!r}") from None


def validate_event(ev: dict) -> dict:
    """Validate one event dict against the registry; returns it unchanged.

    Raises :class:`SchemaError` on a missing key, unknown kind, a phase the
    kind does not allow, a missing required arg, or a non-JSON-scalar value.
    """
    if not isinstance(ev, dict):
        raise SchemaError(f"event must be a dict, got {type(ev).__name__}")
    for k in REQUIRED_KEYS:
        if k not in ev:
            raise SchemaError(f"event missing key {k!r}: {ev}")
    kind = ev["kind"]
    if kind not in EVENT_KINDS:
        raise SchemaError(f"unknown event kind {kind!r}")
    _, phases, required = EVENT_KINDS[kind]
    if ev["ph"] not in phases:
        raise SchemaError(
            f"kind {kind!r} does not allow phase {ev['ph']!r}")
    if not isinstance(ev["t"], (int, float)) or isinstance(ev["t"], bool):
        raise SchemaError(f"t must be numeric, got {ev['t']!r}")
    if not isinstance(ev["args"], dict):
        raise SchemaError("args must be a dict")
    for k in required:
        if ev["ph"] != "E" and k not in ev["args"]:
            raise SchemaError(
                f"kind {kind!r} event missing required arg {k!r}: {ev}")
    if kind == "plan" and ev["name"] not in PLAN_CAUSES:
        raise SchemaError(
            f"plan event cause {ev['name']!r} not in {PLAN_CAUSES}")
    for k, v in ev["args"].items():
        if not isinstance(v, (int, float, str, bool, type(None), list,
                              tuple)):
            raise SchemaError(
                f"arg {k}={v!r} is not JSON-serializable scalar/list")
    return ev


def validate_events(events: Iterable[dict]) -> List[dict]:
    return [validate_event(e) for e in events]


def _main(argv: List[str]) -> int:
    import json
    import sys
    if not argv:
        print("usage: python -m repro.obs.schema trace.jsonl [...]",
              file=sys.stderr)
        return 2
    total = 0
    for path in argv:
        with open(path) as fh:
            for lineno, line in enumerate(fh, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    validate_event(json.loads(line))
                except (SchemaError, json.JSONDecodeError) as e:
                    print(f"{path}:{lineno}: {e}", file=sys.stderr)
                    return 1
                total += 1
    print(f"ok: {total} events valid across {len(argv)} file(s)")
    return 0


if __name__ == "__main__":  # pragma: no cover
    import sys
    sys.exit(_main(sys.argv[1:]))
