#!/usr/bin/env python3
"""The knee sweep and the LS-alone limit run of a cell, in one process.

    python3 perfbench/tools/sweep.py --workload CELL --seed N \\
        --rates 0.5,1,1.5 [--alone-rate 0.5] [--seconds 30] [--out FILE]

First the cell's LS traffic alone (no BE backlog) at ``--alone-rate``:
its TTFT p50 and mean-time-per-output-token p50, whose five-fold values
are the cell's limits. Then the cell at each rate of ``--rates``, with its
BE backlog: LS requests outstanding (due, not finished) at the window's
opening and at its close, TTFT p50 over the window's first and second
halves, TTFT p90, TBT p99 and BE tokens/s, the output check and the KV
pages held. The knee is the highest rate whose outstanding LS requests
did not grow over the window (no more at its close than at its opening);
the cell's rate is 0.8 of it. Each reading is one JSON line.
"""
import argparse
import time

from _common import emit, setup


def outstanding(tl, t):
    return sum(1 for r in tl.ls if r.due <= t
               and (r.failed or not r.tokens or r.tokens[-1] > t))


def summary(res, run, rate):
    from perfbench.timeline import (be_tokens_in_window, ls_gaps_s,
                                    percentile, ttft_percentile_ms)
    tl = run.timeline
    due = tl.ls_due()
    mid = (tl.t0 + tl.t1) / 2
    first = [r.ttft_s for r in due if r.due < mid]
    second = [r.ttft_s for r in due if r.due >= mid]
    served = [r for r in due if not r.failed]
    gaps = ls_gaps_s(tl)
    out = {
        "rate": rate, "due": len(due), "failed": len(due) - len(served),
        "outstanding_open": outstanding(tl, tl.t0),
        "outstanding_close": outstanding(tl, tl.t1),
        # at the window's opening, each quarter and its close
        "outstanding_quarters": [
            outstanding(tl, tl.t0 + k / 4 * (tl.t1 - tl.t0))
            for k in range(5)],
        "correct": res["correct"], "checks": res["checks"],
        "kv_filled": res["kv_filled"],
        "ttft_p50_ms_first_half": _ms(percentile(first, 50)),
        "ttft_p50_ms_second_half": _ms(percentile(second, 50)),
        "ttft_p50_ms": _ms(percentile([r.ttft_s for r in due], 50)),
        "ttft_p90_ms": ttft_percentile_ms(tl, 90),
        "tpot_p50_ms": _ms(percentile([r.tpot_s for r in served], 50)),
        "tbt_p50_ms": _ms(percentile(gaps, 50)),
        "tbt_p99_ms": _ms(percentile(gaps, 99)),
        "be_tokens_per_s": be_tokens_in_window(tl) / (tl.t1 - tl.t0),
    }
    for cls in ("LS", "BE"):
        q = [b - a for a, b, c in tl.quanta if c == cls and tl.in_window(b)]
        out[f"quanta_per_s_{cls}"] = len(q) / (tl.t1 - tl.t0)
        out[f"quantum_ms_p50_{cls}"] = _ms(percentile(q, 50))
        out[f"quantum_ms_max_{cls}"] = _ms(max(q)) if q else None
    return out


def _ms(v):
    return None if v is None else v * 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--alone-rate", type=float, default=0.5,
                    help="0 skips the LS-alone run")
    ap.add_argument("--seconds", type=int, default=30)
    ap.add_argument("--preroll", type=float, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    cat = setup()
    from perfbench.harness import run_cell
    base = {} if args.preroll is None else {"preroll_s": args.preroll}
    if args.alone_rate > 0:
        t = time.perf_counter()
        res, run = run_cell(cat, args.workload, args.seed, args.seconds,
                            False, override=dict(base,
                                                 ls_rate=args.alone_rate,
                                                 be_waiting=0))
        rec = summary(res, run, args.alone_rate)
        rec.update(kind="ls_alone", workload=args.workload,
                   ttft_limit_ms=5 * rec["ttft_p50_ms"],
                   tpot_limit_ms=5 * rec["tpot_p50_ms"],
                   wall_s=time.perf_counter() - t)
        emit(args.out, rec)
    for i, rate in enumerate(float(x) for x in args.rates.split(",")):
        t = time.perf_counter()
        res, run = run_cell(cat, args.workload, args.seed + 1 + i,
                            args.seconds, False,
                            override=dict(base, ls_rate=rate))
        rec = summary(res, run, rate)
        rec.update(kind="sweep", workload=args.workload,
                   wall_s=time.perf_counter() - t)
        emit(args.out, rec)


if __name__ == "__main__":
    main()
