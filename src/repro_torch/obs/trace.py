"""Zero-dependency structured tracer on the engine's virtual clock.

Determinism contract (same as :class:`repro.serving.faults.FaultPlane`): the
tracer never reads a clock itself -- every ``emit`` takes the timestamp from
the caller, who passes the owning engine's virtual ``clock()``.  Two seeded
replays therefore produce byte-identical JSONL streams, and because tracing
is pure observation (no producer branches on tracer state), a traced run is
bit-equal to an untraced one.

Verbosity is filtered per event *kind* at emit time (``coarse`` < ``info`` <
``debug``; see :mod:`repro.obs.schema`).  A tracer at level ``"off"`` drops
everything, so engines can own one unconditionally and call sites stay
branch-free.

Flight recorder: every retained event also lands in a bounded ring buffer.
``dump_on("violation", "plan:watchdog", ...)`` arms triggers; when a matching
event is emitted the ring contents (the last ~N quanta of activity) are
snapshotted into ``tracer.dumps`` for postmortem, rate-limited to
``max_dumps`` snapshots per run.
"""
from __future__ import annotations

import json
from collections import deque
from typing import Dict, List, Optional, Tuple

from .schema import LEVELS, kind_level, validate_event

#: default flight-recorder triggers (SLO violation, watchdog trip,
#: grow_deadlock shed)
DEFAULT_TRIGGERS = ("violation", "plan:watchdog", "recovery:grow_deadlock")


def _jsonable(v):
    """Coerce numpy scalars / tuples so json.dumps never sees foreign types."""
    if isinstance(v, (str, bool, int, float, type(None))):
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    item = getattr(v, "item", None)
    if callable(item):
        return item()
    return str(v)


class Tracer:
    """Typed span/instant/counter event sink with a flight-recorder ring."""

    def __init__(self, level: str = "info", *, ring: int = 2048,
                 max_dumps: int = 8, validate: bool = False):
        if level not in LEVELS:
            raise ValueError(f"unknown trace level {level!r}")
        self.level_name = level
        self.level = LEVELS[level]
        self.validate = validate
        self.events: List[dict] = []
        self.ring: deque = deque(maxlen=int(ring))
        self.dumps: List[dict] = []
        self.max_dumps = int(max_dumps)
        self._triggers: set = set()
        self.dropped = 0
        if level != "off":
            self.dump_on(*DEFAULT_TRIGGERS)

    # -- filtering ------------------------------------------------------
    def enabled(self, kind: str) -> bool:
        return self.level >= kind_level(kind)

    # -- emission -------------------------------------------------------
    def emit(self, ph: str, kind: str, name: str, t: float, track: str,
             **args) -> Optional[dict]:
        if self.level < kind_level(kind):
            self.dropped += 1
            return None
        ev = {"t": float(t), "ph": ph, "kind": kind, "name": str(name),
              "track": str(track),
              "args": {k: _jsonable(v) for k, v in args.items()}}
        if self.validate:
            validate_event(ev)
        self.events.append(ev)
        self.ring.append(ev)
        self._maybe_dump(ev)
        return ev

    def emit_raw(self, ev: dict) -> Optional[dict]:
        """Ingest a pre-built event dict (e.g. ``FlowCompletion.to_event``)."""
        if self.level < kind_level(ev["kind"]):
            self.dropped += 1
            return None
        if self.validate:
            validate_event(ev)
        self.events.append(ev)
        self.ring.append(ev)
        self._maybe_dump(ev)
        return ev

    def begin(self, kind: str, name: str, t: float, track: str, **args):
        return self.emit("B", kind, name, t, track, **args)

    def end(self, kind: str, name: str, t: float, track: str, **args):
        return self.emit("E", kind, name, t, track, **args)

    def instant(self, kind: str, name: str, t: float, track: str, **args):
        return self.emit("I", kind, name, t, track, **args)

    def counter(self, name: str, t: float, value: float,
                track: str = "signals", kind: str = "gauge"):
        return self.emit("C", kind, name, t, track, value=value)

    # -- flight recorder ------------------------------------------------
    def dump_on(self, *specs: str) -> None:
        """Arm triggers: each spec is ``"kind"`` or ``"kind:name"``."""
        for spec in specs:
            kind, _, name = spec.partition(":")
            kind_level(kind)  # raises SchemaError on an unknown kind
            self._triggers.add((kind, name or None))

    def _maybe_dump(self, ev: dict) -> None:
        if not self._triggers or len(self.dumps) >= self.max_dumps:
            return
        key = (ev["kind"], None)
        named = (ev["kind"], ev["name"])
        if key in self._triggers or named in self._triggers:
            self.dumps.append({"trigger": ev, "events": list(self.ring)})

    # -- export ---------------------------------------------------------
    def jsonl(self) -> str:
        """Canonical JSONL: one event per line, keys sorted, compact
        separators -- byte-deterministic for identical event streams."""
        return "".join(json.dumps(e, sort_keys=True,
                                  separators=(",", ":")) + "\n"
                       for e in self.events)

    def perfetto(self) -> List[dict]:
        from .export import to_perfetto
        return to_perfetto(self.events)

    def stats(self) -> Dict[str, int]:
        return {"events": len(self.events), "dropped": self.dropped,
                "dumps": len(self.dumps)}


#: module-level sink for producers constructed without a tracer
OFF = Tracer("off", ring=1)
