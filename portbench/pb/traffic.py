"""The general traffic generator: one mix file of parameters in, the
requests of a run out.

Sizes, arrival times and deadline scales come from the mix's own
``sizes_seed``, so every run sends the same set; the run's ``--seed``
permutes the sizes (with their deadlines) within blocks of
``shuffle_block`` consecutive requests and draws the token ids.  Keys of a
mix file:

* ``loop``: "open" (requests due on a schedule) or "closed" (``clients``
  callers, each sending its next request when its last one finished);
* ``mix``: ``{"kind": "families", "families": [...]}`` draws the paper's
  task families (``pb.workload``; all three in equal shares is the
  paper's own draw) or ``{"kind": "uniform", "input": [lo, hi],
  "output": [lo, hi]}`` draws both lengths uniformly;
* ``first_round``: ``{"output": [lo, hi]}``, the outputs of the clients'
  first requests (a closed loop that starts mid-session);
* ``arrivals`` (open loop): ``cv``, ``swing``, ``period_s`` of the
  Mooncake-like gamma arrivals, at the cell's ``rate_rps``;
* ``deadline_scale``: [lo, hi] of the per-request factor on its solo
  latency on the analytic A800;
* ``warmup_s`` (served before the window, part of set-up), ``drain_s``
  (open loop: served after the window while the window's requests still
  run, so that each meets or misses its deadline), ``sizes_seed``,
  ``shuffle_block``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from pb import workload as W
from pb.counts import Counts


@dataclasses.dataclass
class Request:
    i: int                     # place in the stream
    input_len: int
    output_len: int
    slo: Optional[float]       # seconds from due to deadline
    due: Optional[float] = None   # seconds after the traffic's start (open)


def _draw_sizes(mix: dict, n: int, rng) -> List[tuple]:
    if mix["kind"] == "families":
        fams = tuple(mix["families"])
        paper = fams == W.FAMILY_ORDER
        out = []
        for _ in range(n):
            fam = None if paper else fams[rng.integers(len(fams))]
            d = W.sample_request(rng, fam)
            out.append((d.input_len, d.output_len))
        return out
    if mix["kind"] == "uniform":
        lo, hi = mix["input"]
        olo, ohi = mix["output"]
        return [(int(rng.integers(lo, hi + 1)), int(rng.integers(olo, ohi + 1)))
                for _ in range(n)]
    raise KeyError(f"unknown mix kind {mix['kind']!r}")


class Traffic:
    """The requests of one run, from the mix file ``params`` and the cell's
    ``settings`` (``rate_rps`` of an open loop)."""

    def __init__(self, params: dict, settings: dict, conf: dict, seed: int,
                 seconds: float, max_len: int):
        self.p = params
        self.seed = int(seed)
        self.vocab = conf["port"]["vocab_size"]
        self.open = params["loop"] == "open"
        self.clients = int(params.get("clients", 0))
        self.warmup_s = float(params.get("warmup_s", 0.0))
        self.drain_s = float(params.get("drain_s", 0.0))
        self.rate = float(settings["rate_rps"]) if self.open else None
        c = Counts.of(conf)
        self.fp = W.Footprint(c.all_params(), c.all_params()
                              - c.layer_params(False) + c.layer_params(True),
                              c.kv_bytes_per_token())
        base = int(params["sizes_seed"])
        if self.open:
            horizon = self.warmup_s + seconds + self.drain_s + 5.0
            n = int(self.rate * horizon * 2) + 64
            a = params["arrivals"]
            arr = W.mooncake_like_arrivals(np.random.default_rng([base, 1]),
                                           n, self.rate, cv=a["cv"],
                                           burst_period=a["period_s"],
                                           swing=a["swing"])
            arr = arr[arr < horizon]
            n = len(arr)
        else:
            arr = None
            n = int(params.get("stream", 4096))
        sizes = _draw_sizes(params["mix"], n, np.random.default_rng([base, 0]))
        lo, hi = params.get("deadline_scale", [1.0, 1.0])
        scales = np.random.default_rng([base, 2]).uniform(lo, hi, size=n)
        first = params.get("first_round")
        if first:
            frng = np.random.default_rng([base, 5])
            for j in range(min(self.clients, n)):
                sizes[j] = (sizes[j][0],
                            int(frng.integers(first["output"][0],
                                              first["output"][1] + 1)))
        order = _block_shuffle(n, int(params.get("shuffle_block", 1)),
                               np.random.default_rng([self.seed, 4]))
        if first:                # the first round stays the first round
            order = _keep_head(order, self.clients)
        self.clipped = 0
        self.requests: List[Request] = []
        for i, j in enumerate(order):
            inp, out = sizes[j]
            out = max(out, 2)           # an engine step yields two tokens
            room = max_len - 1 - inp
            if out > room:
                out, self.clipped = room, self.clipped + 1
            slo = W.solo_latency(W.A800, self.fp, inp, out) * scales[j]
            self.requests.append(Request(i, inp, out, float(slo),
                                         float(arr[i]) if self.open else None))

    def tokens(self, req: Request) -> List[int]:
        """The prompt's token ids, drawn from the run's seed."""
        rng = np.random.default_rng([self.seed, 3, req.i])
        return rng.integers(0, self.vocab, req.input_len).tolist()


def _block_shuffle(n: int, block: int, rng) -> List[int]:
    order = []
    for s in range(0, n, block):
        idx = list(range(s, min(n, s + block)))
        order.extend(int(i) for i in rng.permutation(idx))
    return order


def _keep_head(order: List[int], k: int) -> List[int]:
    """``order`` with the indices below ``k`` first (in their shuffled
    order) and the rest after."""
    return [i for i in order if i < k] + [i for i in order if i >= k]
