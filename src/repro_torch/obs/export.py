"""Exporters: Chrome/Perfetto ``trace_event`` JSON and compact JSONL.

Perfetto mapping: each distinct ``track`` becomes one thread row (tid in
first-seen order, named via ``thread_name`` metadata) under a single process,
so devices/classes/links each get their own lane and B/E spans nest
request -> phase -> chunk within a lane.  Timestamps are virtual-clock units
scaled to microseconds (Perfetto's native unit); ``flow`` instants carry
their measured lifetime and are rendered as complete ("X") slices on the
wire lane.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List

_PH_MAP = {"B": "B", "E": "E", "I": "i", "C": "C"}


def to_perfetto(events: Iterable[dict], *, time_scale: float = 1e6,
                process_name: str = "repro") -> List[dict]:
    """Convert schema events to a Chrome ``trace_event`` array."""
    out: List[dict] = [{
        "name": "process_name", "ph": "M", "pid": 0, "tid": 0,
        "args": {"name": process_name}}]
    tids: Dict[str, int] = {}

    def tid_of(track: str) -> int:
        tid = tids.get(track)
        if tid is None:
            tid = tids[track] = len(tids) + 1
            out.append({"name": "thread_name", "ph": "M", "pid": 0,
                        "tid": tid, "args": {"name": track}})
        return tid

    for ev in events:
        tid = tid_of(ev["track"])
        args = dict(ev["args"])
        args["kind"] = ev["kind"]
        rec = {"name": ev["name"], "cat": ev["kind"], "pid": 0, "tid": tid,
               "ts": ev["t"] * time_scale, "args": args}
        if (ev["kind"] == "flow" and "t_start" in args and "t_end" in args):
            rec["ph"] = "X"
            rec["ts"] = float(args["t_start"]) * time_scale
            rec["dur"] = max(float(args["t_end"]) -
                             float(args["t_start"]), 0.0) * time_scale
        else:
            rec["ph"] = _PH_MAP[ev["ph"]]
            if rec["ph"] == "i":
                rec["s"] = "t"  # thread-scoped instant
            elif rec["ph"] == "C":
                rec["args"] = {ev["name"]: args.get("value", 0.0)}
        out.append(rec)
    return out


def write_perfetto(events: Iterable[dict], path: str, **kw) -> None:
    with open(path, "w") as fh:
        json.dump({"traceEvents": to_perfetto(events, **kw),
                   "displayTimeUnit": "ms"}, fh)


def to_jsonl(events: Iterable[dict]) -> str:
    """Canonical compact JSONL (sorted keys): byte-deterministic."""
    return "".join(json.dumps(e, sort_keys=True, separators=(",", ":"))
                   + "\n" for e in events)


def write_jsonl(events: Iterable[dict], path: str) -> None:
    with open(path, "w") as fh:
        fh.write(to_jsonl(events))
