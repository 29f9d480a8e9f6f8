"""Spans of the serving engine, kept in memory, placed on the profiler's clock.

Each ``InferenceEngine`` holds one ``Tracer`` (``engine.trace``).  A span
has a name, a start and an end on ``time.perf_counter`` (the clock of the
engine's timing events and of the serving loops), the request id or the
span that caused it, a few integer attributes, and whether
``torch.profiler`` was on when it opened.  The engine hands each span the
clock reads it already makes; a span reads the clock itself only where no
read was there, and never waits for the device.

Closed spans are kept as plain tuples in a bounded buffer that drops the
oldest and counts what it drops (``dropped``); ``records()`` gives them
as ``Record``.  ``to_unix_ns`` places a time on the profiler's clock:
kineto stamps host and device events in Unix ns (``time.time_ns``), and
the tracer samples a (``perf_counter_ns``, ``time_ns``) pair when it is
made and at each ``sample_clock()`` (once a decode step), and maps a time
by the nearest pair.

Where the profiler is on when a span opens, and the span names work the
host does inside one engine step (``note=True``), the span also enters
``torch.profiler.record_function(<name>)``, so a trace names the
program's spans; the annotation ends where the span ends or, for a span
whose end waits for a later synchronise, where ``end_note`` says the host
left it.  With the profiler off a span costs that check, a clock read or
two and an append.
"""
from __future__ import annotations

import bisect
import time
from collections import deque
from typing import Deque, List, NamedTuple, Optional

import torch

# engine spans a second, at most: five a decode step at the fastest step
# seen (9.3 ms, an engine stepping back to back), plus admissions; the
# bound holds over four times that for 60 s (warm-up and a 51 s window)
MAX_RECORDS = 1 << 17

profiler_enabled = torch._C._autograd._profiler_enabled


class Record(NamedTuple):
    """A closed span."""
    sid: int                    # the span's id, unique in its tracer
    name: str
    t0: float                   # time.perf_counter seconds
    t1: float
    rid: Optional[int]          # the request it serves
    parent: Optional[int]       # the sid of the span that holds it
    attrs: Optional[dict]       # a few integers
    profiled: bool              # torch.profiler was on when it opened

    @property
    def dt(self) -> float:
        return self.t1 - self.t0


class Span:
    """An open span; ``Tracer.close`` records it."""
    __slots__ = ("sid", "name", "t0", "rid", "parent", "profiled", "note",
                 "child")

    def __init__(self, sid, name, t0, rid, parent, profiled, note):
        self.sid, self.name, self.t0 = sid, name, t0
        self.rid, self.parent = rid, parent
        self.profiled, self.note = profiled, note
        self.child: Optional[Span] = None


class Tracer:
    def __init__(self):
        self._records: Deque[tuple] = deque(maxlen=MAX_RECORDS)
        self._pairs: Deque[tuple] = deque(maxlen=MAX_RECORDS)
        self.dropped = 0
        self._next = 0
        self.sample_clock()

    # -- spans ---------------------------------------------------------------

    def open(self, name: str, t0: float, rid: Optional[int] = None,
             parent: Optional[Span] = None, note: bool = True) -> Span:
        profiled = profiler_enabled()
        rf = None
        if profiled and note:
            rf = torch.profiler.record_function(name)
            rf.__enter__()
        self._next += 1
        return Span(self._next, name, t0, rid,
                    None if parent is None else parent.sid, profiled, rf)

    def end_note(self, span: Span):
        """The host has left the span's work; its end comes later."""
        if span.note is not None:
            span.note.__exit__(None, None, None)
            span.note = None

    def close(self, span: Span, t1: float, **attrs):
        if span.child is not None:
            self.close(span.child, t1)
            span.child = None
        self.end_note(span)
        if len(self._records) == self._records.maxlen:
            self.dropped += 1
        self._records.append((span.sid, span.name, span.t0, t1, span.rid,
                              span.parent, attrs or None, span.profiled))

    def next_child(self, span: Span, name: str, t: float):
        """Close ``span``'s open child at ``t`` and open ``name`` there, so
        that its children tile it."""
        if span.child is not None:
            self.close(span.child, t)
        span.child = self.open(name, t, span.rid, span)

    def records(self) -> List[Record]:
        return [Record._make(r) for r in self._records]

    # -- the profiler's clock -------------------------------------------------

    def sample_clock(self):
        self._pairs.append((time.perf_counter_ns(), time.time_ns()))

    def to_unix_ns(self, t: float) -> int:
        """``t`` (``time.perf_counter`` seconds) in Unix ns, by the offset of
        the pair sampled nearest to it."""
        ns = int(round(t * 1e9))
        pairs = self._pairs
        k = bisect.bisect_left(pairs, (ns,))
        near = min((pairs[j] for j in (k - 1, k) if 0 <= j < len(pairs)),
                   key=lambda p: abs(p[0] - ns))
        return ns + near[1] - near[0]
