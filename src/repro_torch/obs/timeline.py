"""SLO timeline: windowed attainment scoring with violation attribution.

Input is any schema-valid event stream.  Requests finish as ``request`` /
``done`` instants whose ``args.ok`` is True (met SLO), False (violated), or
None (no SLO configured -- excluded from attainment).  For each fixed-width
window the timeline scores attainment, then attributes every violation in
the window to the *cause* events (``fault``, ``plan``, ``recovery``,
``swap``, ``lending``) that overlap the violating request's lifetime
``[t_submit, t_done]`` -- so a TBT spike at t=4.2s reads as e.g.
``fault:thermal_throttle x3, plan:slo_guard x1`` instead of a bare number.
Requests with no overlapping cause are tallied as ``unattributed`` (pure
queueing/load violations).
"""
from __future__ import annotations

from bisect import bisect_left, bisect_right
from collections import Counter as _Counter
from typing import Dict, Iterable, List, Optional, Sequence

CAUSE_KINDS = ("fault", "plan", "recovery", "swap", "lending")


class SLOTimeline:
    def __init__(self, events: Iterable[dict], *,
                 window: Optional[float] = None, top_k: int = 3,
                 cause_kinds: Sequence[str] = CAUSE_KINDS):
        self.events = list(events)
        self.top_k = int(top_k)
        self._causes = sorted(
            (e for e in self.events if e["kind"] in cause_kinds),
            key=lambda e: e["t"])
        self._cause_ts = [e["t"] for e in self._causes]
        self.dones = [e for e in self.events
                      if e["kind"] == "request" and e["name"] == "done"
                      and e["args"].get("ok") is not None]
        ts = [e["t"] for e in self.events]
        self.t0 = min(ts) if ts else 0.0
        self.t1 = max(ts) if ts else 0.0
        if window is None:
            window = max((self.t1 - self.t0) / 20.0, 1e-9)
        self.window = float(window)
        self.windows = self._score()

    # -- internals ------------------------------------------------------
    def _attribute(self, done: dict) -> List[str]:
        lo = done["args"].get("t_submit", done["t"])
        hi = done["t"]
        i = bisect_left(self._cause_ts, lo)
        j = bisect_right(self._cause_ts, hi)
        return [f"{e['kind']}:{e['name']}" for e in self._causes[i:j]]

    def _score(self) -> List[dict]:
        out: List[dict] = []
        if not self.dones:
            return out
        n_win = int((self.t1 - self.t0) / self.window) + 1
        buckets: List[List[dict]] = [[] for _ in range(n_win)]
        for e in self.dones:
            k = min(int((e["t"] - self.t0) / self.window), n_win - 1)
            buckets[k].append(e)
        for k, evs in enumerate(buckets):
            if not evs:
                continue
            ok = sum(1 for e in evs if e["args"]["ok"])
            viols = [e for e in evs if not e["args"]["ok"]]
            causes: _Counter = _Counter()
            for v in viols:
                attributed = self._attribute(v)
                causes.update(attributed if attributed else ["unattributed"])
            out.append({
                "t0": self.t0 + k * self.window,
                "t1": self.t0 + (k + 1) * self.window,
                "n": len(evs), "ok": ok,
                "attainment": ok / len(evs),
                "violations": len(viols),
                "causes": causes.most_common(self.top_k),
            })
        return out

    # -- reporting ------------------------------------------------------
    @property
    def overall_attainment(self) -> Optional[float]:
        if not self.dones:
            return None
        return sum(1 for e in self.dones
                   if e["args"]["ok"]) / len(self.dones)

    def violation_windows(self) -> List[dict]:
        return [w for w in self.windows if w["violations"]]

    def all_violations_attributed(self) -> bool:
        """True iff every violation window carries >=1 attributed (i.e.
        non-``unattributed``) cause -- the chaos-bench acceptance check."""
        return all(any(c != "unattributed" for c, _ in w["causes"])
                   for w in self.violation_windows())

    def report(self) -> dict:
        return {"window": self.window,
                "overall_attainment": self.overall_attainment,
                "violation_windows": len(self.violation_windows()),
                "windows": self.windows}

    def format_table(self) -> str:
        """Aligned violation-attribution table (one row per window)."""
        rows = [("window", "done", "ok", "attain", "top causes")]
        for w in self.windows:
            causes = ", ".join(f"{c} x{n}" for c, n in w["causes"]) or "-"
            rows.append((f"[{w['t0']:.1f},{w['t1']:.1f})",
                         str(w["n"]), str(w["ok"]),
                         f"{w['attainment']:.3f}", causes))
        widths = [max(len(r[i]) for r in rows) for i in range(4)]
        lines = ["  ".join(r[i].rjust(widths[i]) for i in range(4))
                 + "  " + r[4] for r in rows]
        oa = self.overall_attainment
        lines.append(f"overall attainment: "
                     f"{oa:.4f}" if oa is not None else "no SLO requests")
        return "\n".join(lines)
