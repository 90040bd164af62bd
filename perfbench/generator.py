"""The one traffic generator: LS arrivals and lengths, and the BE backlog,
from a traffic mix's parameters (``traffic/<mix>.json``) and a seed.

Every seed gets the same work in another order. Each segment (pre-roll,
window, drain) is cut into equal blocks of at most the mix's ``block_s``
seconds; a block of ``seconds`` at ``rate`` holds exactly
``round(rate * seconds)`` arrivals whose gaps are the exponential
distribution's quantiles at ``(i + 0.5) / n``, shuffled by the seed and
scaled to end inside the block: a Poisson stream's gaps, stratified.
Prompt and output lengths are their distributions' quantiles in the same
way, each shuffled on its own. So every block carries one fixed multiset
of gaps and sizes, and two seeds differ only in the order within blocks
and in the token ids: the seed moves no work, and a cluster of long
prompts cannot pile up across a block's edge. (A block of n requests
draws no length beyond its top quantile, ``(n - 0.5) / n``.)

The mix's file gives ``block_s`` and, for each class (``ls``, ``be``),
the ``prompt`` and ``output`` length distributions (:func:`quantile`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist
from typing import List

import numpy as np

_NORMAL = NormalDist()


def quantile(dist: dict, u: float) -> float:
    """The length distribution ``dist`` at quantile ``u`` in (0, 1).
    ``{"dist": "uniform", "lo", "hi"}`` or ``{"dist": "lognormal",
    "median", "sigma", "lo", "hi"}`` (clipped to [lo, hi]) or
    ``{"dist": "fixed", "value"}``."""
    kind = dist["dist"]
    if kind == "fixed":
        return float(dist["value"])
    if kind == "uniform":
        return dist["lo"] + u * (dist["hi"] - dist["lo"])
    if kind == "lognormal":
        x = dist["median"] * math.exp(dist["sigma"] * _NORMAL.inv_cdf(u))
        return min(max(x, dist["lo"]), dist["hi"])
    raise ValueError(f"unknown length distribution {kind!r}")


def lengths(dist: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` whole lengths: the quantiles at (i + 0.5) / n, shuffled."""
    vals = np.array([int(round(quantile(dist, (i + 0.5) / n)))
                     for i in range(n)], np.int64)
    return rng.permutation(vals)


def arrivals(rate: float, start: float, seconds: float,
             rng: np.random.Generator) -> np.ndarray:
    """Due times in [start, start + seconds): round(rate * seconds) of
    them, the stratified exponential gaps shuffled and scaled so that the
    last lands one mean gap before the segment's end."""
    n = int(round(rate * seconds))
    if n <= 0:
        return np.zeros(0)
    gaps = rng.permutation(np.array([-math.log(1.0 - (i + 0.5) / n)
                                     for i in range(n)]))
    c = np.cumsum(gaps)
    return start + seconds * c / (c[-1] + c[-1] / n)


@dataclass
class Request:
    due: float            # seconds after the traffic's start (LS), or 0
    prompt: np.ndarray    # int32 token ids
    max_new: int
    segment: str          # "preroll", "window", "drain" or "backlog"


def _tokens(rng, vocab: int, n: int) -> np.ndarray:
    return rng.integers(0, vocab, n, dtype=np.int64).astype(np.int32)


def blocks(start: float, seconds: float, block_s: float):
    """``[start, start + seconds)`` cut into equal blocks of at most
    ``block_s``: (start, seconds) of each."""
    k = max(1, math.ceil(seconds / block_s - 1e-9))
    return [(start + i * seconds / k, seconds / k) for i in range(k)]


def ls_stream(mix: dict, rate: float, segments, vocab: int, seed: int,
              block_s: float) -> List[Request]:
    """The LS requests of a run: for each block of each ``(name, start,
    seconds)`` of ``segments`` its own stratified arrivals and lengths."""
    rng = np.random.default_rng([seed % 2 ** 63, 1])
    out: List[Request] = []
    for name, s0, s1 in segments:
        for start, seconds in blocks(s0, s1, block_s):
            due = arrivals(rate, start, seconds, rng)
            n = len(due)
            if n == 0:
                continue
            plen = lengths(mix["prompt"], n, rng)
            olen = lengths(mix["output"], n, rng)
            for t, p, o in zip(due, plen, olen):
                out.append(Request(float(t), _tokens(rng, vocab, int(p)),
                                   int(o), name))
    return out


def be_backlog(mix: dict, n: int, vocab: int, seed: int,
               joined: int = 0) -> List[Request]:
    """``n`` BE requests in the order the backlog hands them out. The
    first ``joined`` stand for a backlog joined part-way: each generates
    only the rest of its output, a stratified uniform share of it, so
    that the slots they fill free up one by one as in a steady state, and
    not together as a cohort started at once would."""
    rng = np.random.default_rng([seed % 2 ** 63, 2])
    plen = lengths(mix["prompt"], n, rng)
    olen = lengths(mix["output"], n, rng)
    if joined:
        share = rng.permutation([(i + 0.5) / joined for i in range(joined)])
        olen[:joined] = np.maximum(1, np.round(olen[:joined] * share))
    return [Request(0.0, _tokens(rng, vocab, int(p)), int(o), "backlog")
            for p, o in zip(plen, olen)]
