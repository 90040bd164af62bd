"""Windowed metrics: nearest-rank percentiles, log-linear histograms, and
the :class:`MetricsRegistry` shared by the engine, the controller's
``LoadSignal``, and the benchmarks.

Percentile convention -- nearest-rank, not linear interpolation
---------------------------------------------------------------
``np.percentile`` defaults to linear interpolation between order statistics,
which *understates* tail percentiles on small samples: p99 of ten samples
``[1..10]`` comes out 9.91, i.e. below every observation in the top 1%.  For
SLO accounting that bias matters -- a reported "p99" that no request actually
experienced.  Everything here uses the nearest-rank definition instead
(rank = ceil(q/100 * n), 1-based), so p99 of a 10-sample set is the maximum
observed value and every reported percentile is a real sample.  The engine,
the sim result rollups, and the benchmarks all route through these helpers
so they report the same number for the same data.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence


def percentile(vals: Sequence[float], q: float) -> Optional[float]:
    """Exact nearest-rank percentile; ``None`` on an empty sample."""
    xs = sorted(float(v) for v in vals)
    if not xs:
        return None
    if q <= 0:
        return xs[0]
    rank = math.ceil(q / 100.0 * len(xs))
    return xs[min(max(rank, 1), len(xs)) - 1]


def pcts(vals: Sequence[float], spec: Dict[str, float],
         scale: float = 1.0) -> Dict[str, Optional[float]]:
    """Batch percentiles: ``pcts(gaps, {"p50": 50, "p99": 99}, 1e3)`` ->
    ``{"p50_ms": ..., "p99_ms": ...}`` (``None`` entries on empty input)."""
    xs = sorted(float(v) for v in vals)
    out: Dict[str, Optional[float]] = {}
    for key, q in spec.items():
        if not xs:
            out[f"{key}_ms"] = None
        else:
            rank = math.ceil(q / 100.0 * len(xs)) if q > 0 else 1
            out[f"{key}_ms"] = xs[min(max(rank, 1), len(xs)) - 1] * scale
    return out


class Histogram:
    """Log-linear histogram with a cumulative store and a resettable window.

    Buckets are ``subbins`` geometric subdivisions per octave (power of two),
    giving a bounded relative error of ``2**(1/(2*subbins)) - 1`` (~1.1% at
    the default 32) on any reported quantile.  Non-positive samples land in a
    dedicated underflow bucket.  Percentiles are nearest-rank over bucket
    midpoints (see module docstring).
    """

    def __init__(self, subbins: int = 32):
        self.subbins = int(subbins)
        self.counts: Dict[int, int] = {}
        self.window_counts: Dict[int, int] = {}
        self.n = 0
        self.window_n = 0
        self.total = 0.0

    _UNDER = -(10 ** 9)

    def _bucket(self, v: float) -> int:
        if v <= 0.0:
            return self._UNDER
        return math.floor(math.log2(v) * self.subbins)

    def _value(self, b: int) -> float:
        if b == self._UNDER:
            return 0.0
        return 2.0 ** ((b + 0.5) / self.subbins)

    def record(self, v: float) -> None:
        b = self._bucket(float(v))
        self.counts[b] = self.counts.get(b, 0) + 1
        self.window_counts[b] = self.window_counts.get(b, 0) + 1
        self.n += 1
        self.window_n += 1
        self.total += float(v)

    def tick(self) -> None:
        """Close the current window (cumulative store is untouched)."""
        self.window_counts = {}
        self.window_n = 0

    def percentile(self, q: float, window: bool = False) -> Optional[float]:
        counts = self.window_counts if window else self.counts
        n = self.window_n if window else self.n
        if n == 0:
            return None
        rank = max(1, math.ceil(q / 100.0 * n)) if q > 0 else 1
        cum = 0
        for b in sorted(counts):
            cum += counts[b]
            if cum >= rank:
                return self._value(b)
        return self._value(max(counts))  # pragma: no cover

    def mean(self) -> Optional[float]:
        return self.total / self.n if self.n else None

    def snapshot(self) -> dict:
        return {"n": self.n, "window_n": self.window_n,
                "mean": self.mean(),
                "p50": self.percentile(50), "p99": self.percentile(99),
                "window_p99": self.percentile(99, window=True)}


class Counter:
    """Monotonic counter with a per-window delta."""

    def __init__(self):
        self.value = 0.0
        self.window = 0.0

    def add(self, v: float = 1.0) -> None:
        self.value += v
        self.window += v

    def tick(self) -> None:
        self.window = 0.0

    def snapshot(self) -> dict:
        return {"value": self.value, "window": self.window}


class Gauge:
    """Last-write-wins gauge; keeps the previous window's last value too so
    the timeline can show value-vs-transition even across quiet windows."""

    def __init__(self):
        self.value: Optional[float] = None
        self.prev: Optional[float] = None

    def set(self, v: float) -> None:
        self.value = float(v)

    def tick(self) -> None:
        self.prev = self.value

    def snapshot(self) -> dict:
        return {"value": self.value, "prev": self.prev}


class MetricsRegistry:
    """Named counters/gauges/histograms with a shared window clock.

    ``tick()`` is called once per control interval by the owner (the engine's
    ``_load_signal``); windowed reads (``window_percentile``, counter deltas)
    then cover exactly one control window, which is what ``LoadSignal``
    consumes -- the controller sees the same numbers ``metrics()`` reports.
    """

    def __init__(self):
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}
        self.ticks = 0

    def counter(self, name: str) -> Counter:
        return self.counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        return self.gauges.setdefault(name, Gauge())

    def histogram(self, name: str, subbins: int = 32) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(subbins)
        return h

    def tick(self) -> None:
        for m in self.counters.values():
            m.tick()
        for m in self.gauges.values():
            m.tick()
        for m in self.histograms.values():
            m.tick()
        self.ticks += 1

    def snapshot(self) -> dict:
        out: dict = {"ticks": self.ticks}
        for group, store in (("counters", self.counters),
                             ("gauges", self.gauges),
                             ("histograms", self.histograms)):
            if store:
                out[group] = {k: v.snapshot()
                              for k, v in sorted(store.items())}
        return out
