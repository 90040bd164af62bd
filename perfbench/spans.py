"""Spans and the device trace of a ``--trace 1`` run, taken from the
benchmark's side of the program's boundaries.

Each tenant's model calls (the engine's ``decode_fn`` and ``chunk_fn``)
are wrapped: the wrapper waits for the device before and after the call,
so the call's host interval holds all of its device work, records the
call's shape and the positions of the rows it serves (a row at the
engine's write sentinel serves none), and opens a profiler annotation
``pb:<class>:<kind>#<index>``. ``torch.profiler`` runs over a fixed
sub-window of the measured window; device activities are matched to the
calls by time (their intervals fall inside the call's annotation).
Nothing inside the program changes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


@dataclass
class Call:
    cls: str                 # "LS" or "BE"
    kind: str                # "decode" or "prefill"
    sq: int                  # tokens a row
    rows: int                # rows computed (the tenant's slot pool)
    starts: List[int]        # positions of the rows it serves
    t0: float                # host clock, device idle before
    t1: float                # host clock, device idle after
    kernels: Optional[List[Tuple[str, float]]] = None  # profiled: (name, s)


@dataclass
class Trace:
    """What the readers of the per-layer metrics read."""
    calls: List[Call] = field(default_factory=list)
    window_s: Optional[float] = None       # the profiled sub-window
    busy_s: Optional[float] = None         # union of device activity
    device_ops: List[list] = field(default_factory=list)
    idle_gaps: List[list] = field(default_factory=list)

    def in_window(self, tl, cls: str, kind: str) -> List[Call]:
        """The calls of a class and kind that ended inside the window."""
        return [c for c in self.calls if c.cls == cls and c.kind == kind
                and tl.in_window(c.t1)]


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def warm_profiler():
    """Start and stop the profiler once in set-up: its first start in a
    process (CUPTI's) takes seconds, which the window must not pay."""
    with torch.profiler.profile(activities=_activities()):
        x = torch.ones(8, device="cuda" if torch.cuda.is_available()
                       else "cpu")
        (x + 1).sum().item()


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    return f() if f is not None else int(getattr(e, f"{what}_us")() * 1e3)


class Recorder:
    """Installs the wrappers and runs the profiler for ``seconds`` from
    the first step at or after ``t_on`` of the host clock, ending no later
    than ``t_limit``."""

    def __init__(self, clock, t_on: float, seconds: float, t_limit: float):
        self.clock = clock
        self.t_on, self.seconds, self.t_limit = t_on, seconds, t_limit
        self.t_off = t_limit
        self.trace = Trace()
        self.prof = None
        self.state = "before"
        self._window_rf = None

    def wrap(self, rt, cls: str, on_cuda: bool):
        """Wrap the tenant's model calls; a row at the engine's write
        sentinel (a position past the page table) serves nothing."""
        sentinel = rt.kv.pages_per_slot * rt.kv.page_size
        sync = torch.cuda.synchronize if on_cuda else (lambda: None)
        rf = torch.profiler.record_function

        def make(kind, fn):
            def call(p, toks, cache, pos, pt=None):
                sync()
                pos_h = pos.cpu().numpy()
                idx = len(self.trace.calls)
                t0 = self.clock()
                with rf(f"pb:{cls}:{kind}#{idx}"):
                    out = fn(p, toks, cache, pos, pt)
                    sync()
                t1 = self.clock()
                self.trace.calls.append(Call(
                    cls, kind, int(toks.shape[1]), int(toks.shape[0]),
                    [int(x) for x in pos_h if x < sentinel], t0, t1))
                return out
            return call

        rt.decode_fn = make("decode", rt.decode_fn)
        rt.chunk_fn = make("prefill", rt.chunk_fn)

    def hook(self, now: float):
        """Called by the driver before each step."""
        if self.state == "before" and now >= self.t_on:
            self.prof = torch.profiler.profile(activities=_activities())
            self.prof.__enter__()
            self._window_rf = torch.profiler.record_function("pb:profiled")
            self._window_rf.__enter__()
            # the profiler's start takes a while: the sub-window runs from
            # its end
            self.t_off = min(self.clock() + self.seconds, self.t_limit)
            self.state = "on"
        elif self.state == "on" and now >= self.t_off:
            self.stop()

    def stop(self):
        if self.state != "on":
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._window_rf.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.state = "done"

    def finish(self) -> Trace:
        """Match the profiled device activity to the calls."""
        self.stop()
        if self.prof is None:
            return self.trace
        events = list(self.prof.profiler.kineto_results.events())
        spans, win = {}, None
        dev = []
        for e in events:
            name = e.name()
            if str(e.device_type()).endswith("CUDA"):
                # the device's copies of the annotations are no activity
                if not name.startswith("pb:") and not _annotation(e):
                    s = _ns(e, "start")
                    dev.append((s, s + _ns(e, "duration"), name))
            elif name.startswith("pb:"):
                s = _ns(e, "start")
                iv = (s, s + _ns(e, "duration"))
                if name == "pb:profiled":
                    win = iv
                else:
                    spans[int(name.rsplit("#", 1)[1])] = (iv, name)
        if win is None:
            return self.trace
        dev = [(max(a, win[0]), min(b, win[1]), n) for a, b, n in dev
               if b > win[0] and a < win[1]]
        dev.sort()
        self.trace.window_s = (win[1] - win[0]) * 1e-9
        self.trace.busy_s = _union(dev) * 1e-9
        self._attribute(dev, spans)
        self.trace.device_ops = _top_ops(dev)
        self.trace.idle_gaps = _idle_by_host(dev, win, spans)
        return self.trace

    def _attribute(self, dev, spans):
        starts = np.array([a for a, _, _ in dev], np.int64)
        for idx, ((a, b), _) in spans.items():
            lo = int(np.searchsorted(starts, a, "left"))
            hi = int(np.searchsorted(starts, b, "right"))
            self.trace.calls[idx].kernels = [
                (n, (e - s) * 1e-9) for s, e, n in dev[lo:hi] if e <= b]


def _annotation(e) -> bool:
    f = getattr(e, "is_user_annotation", None)
    return bool(f()) if f is not None else False


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def _union(dev) -> int:
    total, end = 0, None
    for a, b, _ in dev:
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _top_ops(dev, top: int = 10) -> List[list]:
    by: Dict[str, int] = {}
    for a, b, n in dev:
        by[n] = by.get(n, 0) + (b - a)
    return [[n, t * 1e-9] for n, t in
            sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def _idle_by_host(dev, win, spans, top: int = 10) -> List[list]:
    """The device's idle time in the profiled sub-window, by what the host
    was in: a model call of a class and kind, or the engine between
    calls."""
    gaps, end = [], win[0]
    for a, b, _ in dev:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if win[1] > end:
        gaps.append((end, win[1]))
    ivs = sorted((iv, name.split("#")[0][3:]) for iv, name in spans.values())
    by: Dict[str, int] = {}
    j = 0
    for a, b in gaps:
        while j < len(ivs) and ivs[j][0][1] <= a:
            j += 1
        t, k = a, j
        while t < b:
            if k < len(ivs) and ivs[k][0][0] < b:
                s, e = ivs[k][0]
                if s > t:
                    by["engine"] = by.get("engine", 0) + (s - t)
                lo, hi = max(s, t), min(e, b)
                if hi > lo:
                    by[ivs[k][1]] = by.get(ivs[k][1], 0) + (hi - lo)
                t = max(t, e)
                k += 1
            else:
                by["engine"] = by.get("engine", 0) + (b - t)
                t = b
    return [[n, v * 1e-9] for n, v in
            sorted(by.items(), key=lambda kv: -kv[1])[:top]]
