"""The open-loop driver: LS requests submitted when they fall due, a BE
backlog kept full, one engine step at a time, and a timeline recorded
from the engine's own timestamps.

Before each step every LS request whose due time has passed is submitted
with ``at=`` its due time (so TTFT runs from when it was due, whatever the
loop was doing), and the BE queue is topped up to ``be_waiting`` requests
beyond those in service. After each step the driver reads the requests it
follows: an LS request's new output token is stamped with the engine's
``t_last`` (the clock right after the call that made it), a BE request's
prompt progress and new tokens are counted at the step's end. Arrivals and
the backlog go on through the drain, so the requests due in the window
finish under the same load; the drain ends when all of them have been
submitted and have finished, or at ``cap_end``, where the rest count as
failed. The KV pages each tenant holds are read after every step; their
peak is the memory the traffic fills.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional

from .timeline import LSRecord, Timeline


def drive(eng, ls_name: str, be_name: str, ls_reqs, be_reqs, *,
          t_start: float, t0: float, t1: float, cap_end: float,
          be_waiting: int, clock: Callable[[], float],
          hook: Optional[Callable[[float], None]] = None):
    """Run the engine from ``t_start`` (the traffic's zero) until the
    window's LS requests are done or ``cap_end``. Returns (timeline, the
    engine's LS requests, the engine's BE requests)."""
    tl = Timeline(t0, t1)
    be_rt = eng.tenants[be_name]
    ls_live: List[list] = []       # [engine request, record, tokens seen]
    be_live: List[list] = []       # [engine request, prompt pos, tokens]
    ls_out, be_out = [], []
    nxt_ls = nxt_be = 0
    n_ls = len(ls_reqs)
    while True:
        now = clock()
        if hook is not None:
            hook(now)
        while nxt_ls < n_ls and t_start + ls_reqs[nxt_ls].due <= now:
            r = ls_reqs[nxt_ls]
            due = t_start + r.due
            req = eng.submit(ls_name, r.prompt, max_new=r.max_new, at=due)
            rec = LSRecord(due, len(r.prompt), r.max_new)
            tl.ls.append(rec)
            ls_out.append(req)
            ls_live.append([req, rec, 0])
            nxt_ls += 1
        while len(be_rt.queue) < be_waiting and nxt_be < len(be_reqs):
            r = be_reqs[nxt_be]
            req = eng.submit(be_name, r.prompt, max_new=r.max_new)
            be_out.append(req)
            be_live.append([req, 0, 0])
            nxt_be += 1
        n_ev = len(eng.events)
        busy = eng.step()
        t = clock()
        if len(eng.events) > n_ev:
            tl.quanta.append((now, t, eng.events[-1][2]))
        _observe_ls(ls_live)
        _observe_be(be_live, tl, t)
        for cls, name in (("LS", ls_name), ("BE", be_name)):
            kv = eng.tenants[name].kv
            if kv is not None:
                tl.kv_pages_peak[cls] = max(tl.kv_pages_peak.get(cls, 0),
                                            kv.used_pages)
        if t >= cap_end:
            break
        # every request due in the window submitted and finished
        if (t >= t1 and not any(rec.due < t1 for _, rec, _ in ls_live)
                and (nxt_ls == n_ls
                     or t_start + ls_reqs[nxt_ls].due >= t1)):
            break
        if not busy:
            wait = (t_start + ls_reqs[nxt_ls].due - t) if nxt_ls < n_ls \
                else 1e-3
            time.sleep(min(max(wait, 0.0), 1e-3))
    for req, rec, _ in ls_live:      # unserved at the cap
        rec.failed = True
    tl.t_end = clock()
    return tl, ls_out, be_out


def _observe_ls(live):
    keep = []
    for item in live:
        req, rec, seen = item
        n = len(req.output or ())
        if n > seen:
            # one quantum gives a request one token; t_last stamps it
            rec.tokens.extend([req.t_last] * (n - seen))
            item[2] = n
        if req.t_done is not None:
            rec.failed = bool(req.failed)
        else:
            keep.append(item)
    live[:] = keep


def _observe_be(live, tl: Timeline, t: float):
    keep, dp, dg = [], 0, 0
    for item in live:
        req = item[0]
        n = len(req.output or ())
        dp += req.prefill_pos - item[1]
        dg += n - item[2]
        item[1], item[2] = req.prefill_pos, n
        if req.t_done is None:
            keep.append(item)
    live[:] = keep
    if dp or dg:
        tl.be_steps.append((t, dp, dg))
