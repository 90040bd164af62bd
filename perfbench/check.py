"""Whether the timed path served the right tokens.

Once the window has closed and the program's state is freed, a sample of
each tenant's finished requests, drawn from the seed with the longest
among them, is run through the plain float32 reference
(``reference/dense.py``) over its prompt and served tokens, with the
weights the benchmark made. For each served token the gap by which the
reference's logit of it lies below the reference's best at that position
is read; the number compared is the widest gap of the tenant's sample. A
greedy server that computes what the model states serves tokens within
its arithmetic's rounding of the reference's best; a wrong token, a wrong
cache entry or a lower precision shows as a wider gap.

The control (``control=True``) reads, at the same positions of the same
sequences, the gap of the token that the reference computed in float8
puts first: the lower precision a later change would be tempted by.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .reference import dense


def sample(reqs, min_tokens: int, seed: int, salt: int) -> List:
    """Finished requests holding at least ``min_tokens`` served tokens:
    the one with the longest sequence first, then others in an order drawn
    from the seed."""
    done = [r for r in reqs if r.t_done is not None and not r.failed
            and r.output]
    if not done:
        return []
    longest = max(range(len(done)),
                  key=lambda i: len(done[i].tokens) + len(done[i].output))
    rng = np.random.default_rng([seed % 2 ** 63, 3, salt])
    order = [longest] + [int(i) for i in rng.permutation(len(done))
                         if i != longest]
    out, n = [], 0
    for i in order:
        if n >= min_tokens:
            break
        out.append(done[i])
        n += len(done[i].output)
    return out


def gaps(weights, arch: dict, reqs, device, control: bool = False) \
        -> Dict[str, float]:
    """The widest gap over the served tokens of ``reqs`` (``served``) and,
    with ``control``, over the float8 reference's first choices at the
    same positions (``control``); and the tokens and requests read."""
    seqs, at, toks = [], [], []
    for r in reqs:
        out = [int(t) for t in r.output]
        seq = np.concatenate([np.asarray(r.tokens, np.int64),
                              np.asarray(out[:-1], np.int64)])
        seqs.append(torch.as_tensor(seq, device=device))
        L = len(r.tokens)
        at.append(range(L - 1, L - 1 + len(out)))
        toks.append(torch.as_tensor(out, device=device))
    res = {"tokens": float(sum(len(t) for t in toks)),
           "requests": float(len(reqs))}
    if not reqs:
        return res
    ref = dense.logits_at(weights, arch, seqs, at, "float32")
    best = [lg.max(-1).values for lg in ref]
    res["served"] = max(float((b - lg.gather(1, t[:, None])[:, 0]).max())
                        for b, lg, t in zip(best, ref, toks))
    if control:
        low = dense.logits_at(weights, arch, seqs, at, "float8")
        res["control"] = max(
            float((b - lg.gather(1, c.argmax(-1)[:, None])[:, 0]).max())
            for b, lg, c in zip(best, ref, low))
    return res
