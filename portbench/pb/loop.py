"""The clients and the serving loop around the port's engines.

The loop is the port's ``launch.serve.serve`` loop with the clients
outside it: each pass steps each engine once and feeds the estimator
from ``drain_events()``, as ``serve`` does, and before each step submits
every request that has come due (routed by ``launch.serve.route`` over
an ``EMAEstimator``).
After each step it reads the token counts of the engine's requests: a
step ends in a copy to the host, so the host clock then is the time of
the tokens that step produced."""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, List, Optional

from repro_torch.core.estimator import EMAEstimator
from repro_torch.engine.engine import EngineRequest
from repro_torch.launch.serve import route

from pb.traffic import Request, Traffic


@dataclasses.dataclass
class Tracked:
    """A request the harness follows, and what it saw of it."""
    req: Request
    er: EngineRequest
    engine: int
    due: float                 # absolute host time it was due (or sent)
    sent: float
    n: int = 0                 # tokens produced so far
    first_t: Optional[float] = None
    done_t: Optional[float] = None
    chunks: int = 0            # chunked-prefill calls so far
    times: list = dataclasses.field(default_factory=list)  # (t, new tokens)

    @property
    def deadline(self) -> float:
        return self.due + self.req.slo


@dataclasses.dataclass
class StepRec:
    """One engine step: the decode rows' contexts (each counting the new
    token) and the flash calls (queries, keys) of its prefill work."""
    gid: int
    t: float
    ctxs: List[int]
    flash: List[tuple]
    prefill_tokens: int
    traced: bool = False


class Loop:
    def __init__(self, engines, traffic: Traffic, flash_layers: int,
                 clock: Callable[[], float] = time.perf_counter):
        self.engines = engines
        self.traffic = traffic
        self.clock = clock
        self.flash_layers = flash_layers
        self.est = EMAEstimator()
        self.active: List[List[Tracked]] = [[] for _ in engines]
        self.tracked: List[Tracked] = []
        self.events: List[tuple] = []      # (gid, kind, size, dt, t)
        self.steps: List[StepRec] = []
        self.failed: List[Tracked] = []
        self.pending: List[tuple] = []     # (due, Request), sorted by due
        self.next_i = 0
        self.t0: Optional[float] = None
        self.tracing = False
        self.annotate = lambda name: contextlib.nullcontext()
        self.waits: List[tuple] = []      # (time, routed but slotless)

    # -- clients -------------------------------------------------------------

    def start(self):
        """Traffic starts now: an open loop's schedule is due from here; a
        closed loop's clients each send their first request now."""
        self.t0 = self.clock()
        reqs = self.traffic.requests
        if self.traffic.open:
            self.pending = [(self.t0 + r.due, r) for r in reqs]
            self.next_i = len(reqs)
        else:
            self.pending = [(self.t0, r) for r in reqs[:self.traffic.clients]]
            self.next_i = self.traffic.clients

    def _next_of_client(self, now: float):
        if self.next_i >= len(self.traffic.requests):
            raise RuntimeError("the closed loop ran out of requests; raise "
                               "the mix's stream")
        self.pending.append((now, self.traffic.requests[self.next_i]))
        self.next_i += 1

    def _release(self, now: float):
        k = 0
        while k < len(self.pending) and self.pending[k][0] <= now:
            k += 1
        due, self.pending = self.pending[:k], self.pending[k:]
        for t_due, req in due:
            er = EngineRequest(rid=req.i, tokens=self.traffic.tokens(req),
                               prompt_len=req.input_len,
                               max_new_tokens=req.output_len, eos_id=None)
            gid = route(self.engines, self.est)
            tr = Tracked(req, er, gid, t_due, now)
            self.tracked.append(tr)
            try:
                self.engines[gid].submit(er)
            except ValueError:
                self.failed.append(tr)
                if not self.traffic.open:
                    self._next_of_client(now)
                continue
            self.active[gid].append(tr)

    # -- one pass ------------------------------------------------------------

    def _step(self, gid: int, eng):
        chunked = bool(eng.prefill_chunk)
        active = self.active[gid]
        head = next((tr for tr in active if tr.n == 0), None)
        chunk_call = None
        if chunked and head is not None and (
                head.chunks > 0 or any(s is None for s in eng.slots)):
            pos0 = head.chunks * eng.prefill_chunk
            c = min(eng.prefill_chunk, head.req.input_len - pos0)
            chunk_call = (c, pos0 + c)
            head.chunks += 1
        with self.annotate(f"engine{gid}.step"):
            eng.step()
        t = self.clock()
        for kind, size, dt in eng.drain_events():
            if kind == "decode":
                self.est.observe_decode_iter(gid, dt)
            else:
                self.est.observe_prefill(gid, size, dt)
            self.events.append((gid, kind, size, dt, t))
        ctxs, flash, pre = [], [], 0
        if chunk_call is not None and self.flash_layers:
            flash.append(chunk_call)
            pre += chunk_call[0]
        keep = []
        for tr in active:
            n = len(tr.er.tokens) - tr.req.input_len
            if n > tr.n:
                if tr.n == 0:
                    tr.first_t = t
                    if not chunked:
                        pre += tr.req.input_len
                        if self.flash_layers:
                            flash.append((tr.req.input_len,
                                          tr.req.input_len))
                tr.times.append((t, n - tr.n))
                tr.n = n
                ctxs.append(len(tr.er.tokens) - 1)
            if tr.er.done:
                tr.done_t = t
                if not self.traffic.open:
                    self._next_of_client(t)
            else:
                keep.append(tr)
        self.active[gid] = keep
        if ctxs or flash:
            self.steps.append(StepRec(gid, t, ctxs, flash, pre, self.tracing))

    def _sample_wait(self, now: float):
        self.waits.append((now, sum(e.load - sum(s is not None
                                                 for s in e.slots)
                                    for e in self.engines)))

    def one_pass(self):
        """Before each engine's step, submit what has come due."""
        busy = False
        for gid, eng in enumerate(self.engines):
            with self.annotate("harness.submit"):
                self._release(self.clock())
            if eng.load:
                busy = True
                self._step(gid, eng)
        now = self.clock()
        self._sample_wait(now)
        if not busy and self.pending:
            with self.annotate("harness.idle"):
                time.sleep(max(0.0, min(self.pending[0][0] - now, 0.05)))

    def run_until(self, cond: Callable[[float], bool]):
        while not cond(self.clock()):
            self.one_pass()
