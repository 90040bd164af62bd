"""What a run recorded, and the arithmetic of the end-to-end metrics on it.

The driver records, on the engine's clock (``time.perf_counter``): each LS
request's due time and the time of each of its output tokens, and for the
BE tenant the prompt tokens prefilled and the tokens generated at the end
of each engine step. The window is ``[t0, t1)``. Percentiles are
nearest-rank (rank ``ceil(q / 100 * n)``, 1-based), a copy of
``repro_torch/obs/metrics.py::percentile``: every reported percentile is a
sample.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence


def percentile(vals: Sequence[float], q: float) -> Optional[float]:
    """Exact nearest-rank percentile; ``None`` on an empty sample."""
    xs = sorted(float(v) for v in vals)
    if not xs:
        return None
    if q <= 0:
        return xs[0]
    rank = math.ceil(q / 100.0 * len(xs))
    return xs[min(max(rank, 1), len(xs)) - 1]


@dataclass
class LSRecord:
    due: float
    prompt_len: int
    max_new: int
    tokens: List[float] = field(default_factory=list)  # output token times
    failed: bool = False     # not served by the run's end (or rejected)

    @property
    def ttft_s(self) -> float:
        """Due to first token; +inf for a request never served."""
        if self.failed or not self.tokens:
            return math.inf
        return self.tokens[0] - self.due

    @property
    def tpot_s(self) -> float:
        """Mean time per output token after the first (0 for one token);
        +inf for a request never served."""
        if self.failed or not self.tokens:
            return math.inf
        n = len(self.tokens)
        return (self.tokens[-1] - self.tokens[0]) / (n - 1) if n > 1 else 0.0


@dataclass
class Timeline:
    t0: float                          # window opens
    t1: float                          # window closes
    ls: List[LSRecord] = field(default_factory=list)
    # (time, BE prompt tokens prefilled, BE tokens generated) per step
    be_steps: List[tuple] = field(default_factory=list)
    # (start, end, "LS" or "BE") of each engine quantum
    quanta: List[tuple] = field(default_factory=list)
    t_end: Optional[float] = None      # the drain's end
    # "LS", "BE" -> the most KV pages the tenant held after any step
    kv_pages_peak: dict = field(default_factory=dict)

    def in_window(self, t: float) -> bool:
        return self.t0 <= t < self.t1

    def ls_due(self) -> List[LSRecord]:
        """The LS requests due in the window: the ones the LS metrics
        judge."""
        return [r for r in self.ls if self.in_window(r.due)]


def ttft_percentile_ms(tl: Timeline, q: float) -> Optional[float]:
    """The q-th percentile of TTFT over the LS requests due in the window,
    a failed request above every served one. Where the rank falls on a
    failed request, the time it had waited when the run ended (at least
    the largest served TTFT)."""
    reqs = tl.ls_due()
    if not reqs:
        return None
    v = percentile([r.ttft_s for r in reqs], q)
    if math.isinf(v):
        served = [r.ttft_s for r in reqs if not math.isinf(r.ttft_s)]
        waited = max(tl.t_end - r.due for r in reqs if r.failed)
        v = max(served + [waited])
    return v * 1e3


def ls_gaps_s(tl: Timeline) -> List[float]:
    """Every gap between consecutive output tokens of an LS request whose
    later token falls in the window, from any LS request."""
    out = []
    for r in tl.ls:
        for a, b in zip(r.tokens, r.tokens[1:]):
            if tl.in_window(b):
                out.append(b - a)
    return out


def slo_attainment(tl: Timeline, ttft_ms: float, tpot_ms: float) \
        -> Optional[float]:
    """Percent of the LS requests due in the window whose TTFT and mean
    time per output token are both within their limits (a failed request
    misses)."""
    reqs = tl.ls_due()
    if not reqs:
        return None
    ok = sum(r.ttft_s * 1e3 <= ttft_ms and r.tpot_s * 1e3 <= tpot_ms
             for r in reqs)
    return 100.0 * ok / len(reqs)


def be_tokens_in_window(tl: Timeline) -> int:
    """BE prompt tokens prefilled plus BE tokens generated at steps that
    ended inside the window."""
    return sum(p + g for t, p, g in tl.be_steps if tl.in_window(t))
