"""The check that decides ``correct``: the served tokens of a sample of
the requests the window finished, held to the configuration's plain
reference.

The sample is drawn from the run's seed: the request with the most
served tokens, the longest of each engine (so one-shot and chunked
prefill are both covered), then others at random until ``check_tokens``
served tokens and at least ``MIN_REQUESTS`` requests are in it.  The reference runs once over each prompt with
its served tokens, in float32; at every served position the number
compared is how far the served token's logit lies below the reference's
best one (0 where they agree).  The cell's ``limits`` name what has to
stay under its limit: ``logit_gap``, the widest such gap, or
``logit_gap_mean``, their mean over the served tokens (for a cell whose
widest gap swings with single routing flips; see ``PERF.md``)."""
from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from reference import common as C

MIN_REQUESTS = 8       # so that a fault in some slots shows in the sample
MAX_REQUESTS = 24


def sample(tracked, t_end: float, seed: int, n_engines: int,
           target_tokens: int) -> List:
    done = [tr for tr in tracked if tr.done_t is not None
            and tr.done_t <= t_end]
    if not done:
        return []
    served = lambda tr: len(tr.er.tokens) - tr.req.input_len
    chosen = [max(done, key=served)]
    for g in range(n_engines):
        mine = [tr for tr in done if tr.engine == g]
        if mine and max(mine, key=served) not in chosen:
            chosen.append(max(mine, key=served))
    rest = [tr for tr in done if tr not in chosen]
    rng = np.random.default_rng([seed, 6])
    for j in rng.permutation(len(rest)):
        if (sum(map(served, chosen)) >= target_tokens
                and len(chosen) >= MIN_REQUESTS) or \
                len(chosen) >= MAX_REQUESTS:
            break
        chosen.append(rest[int(j)])
    return chosen


def gaps(conf, ref, weights, chosen, control: bool = False,
         stats: dict | None = None):
    """The reference's gap at every served token of ``chosen``, and with
    ``control`` the control's: the gap of the token that the reference
    computed in float8 puts first at each of those positions.  Returns
    (gaps, control gaps or None), float32 tensors, one a served token."""
    V = conf["vocab_size"]
    seqs, served = [], []
    for tr in chosen:
        toks, L = tr.er.tokens, tr.req.input_len
        seqs.append((toks[:-1], L - 1))
        served.append(torch.tensor(toks[L:]))
    with torch.no_grad():
        exact = ref.logits(conf, weights, seqs, C.Arith("fp32"), stats)
        low = (ref.logits(conf, weights, seqs, C.Arith("fp8"))
               if control else None)

    def gap(picks):
        out = []
        for rows, tok in zip(exact, picks):
            tok = tok.to(rows.device)
            best = rows.max(dim=-1).values
            got = rows.gather(1, tok.clamp_max(V - 1)[:, None])[:, 0]
            out.append(torch.where(tok < V, best - got,
                                   torch.full_like(best, math.inf)).cpu())
        return torch.cat(out) if out else torch.zeros(0)
    return gap(served), (gap([r.argmax(dim=-1) for r in low])
                         if control else None)


def stats(g) -> dict:
    """How the gaps of a run spread: their widest, high quantiles, mean,
    the share of served tokens more than 0.1 below the best, and where
    the widest lies (0 = the token prefill produced)."""
    if g is None or not g.numel():
        return {}
    g = g.double()
    return {"max": float(g.max()), "p99": float(g.quantile(0.99)),
            "p90": float(g.quantile(0.90)), "mean": float(g.mean()),
            "over_0.1": float((g > 0.1).double().mean()),
            "n": int(g.numel()), "at": int(g.argmax())}
