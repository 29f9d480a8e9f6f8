"""The program's own spans: each engine's ``trace`` (``repro_torch``'s
``engine/trace.py``), read over the window.  A program whose engines keep
no spans gives nothing here, and each reader then reads None.

Times read from spans leave out those opened under the profiler: it
makes a decode step's graph launch take about 10 ms in place of 0.1 and
doubles an eager prefill call (H100, torch 2.11), so a traced run's last
seconds would time the profiler.  The device's share of a span can only
be read from those."""
from __future__ import annotations

import bisect

from pb.trace import _union


def tracers(run):
    return [e.trace for e in run.loop.engines if hasattr(e, "trace")]


def closed(run, name, profiled=False):
    """[(tracer, record)] of the ``name`` spans that closed in the window
    and opened with the profiler on (``profiled``) or off."""
    return [(tr, r) for tr in tracers(run) for r in tr.records()
            if r.name == name and r.profiled == profiled
            and run.in_window(r.t1)]


def host_ms(run, name="decode", wait="decode.wait"):
    """Mean ms over the window's ``name`` spans of the span less its
    ``wait`` child."""
    less = []
    for tr in tracers(run):
        recs = tr.records()
        waits = {r.parent: r.dt for r in recs if r.name == wait}
        less += [r.dt - waits[r.sid] for r in recs
                 if r.name == name and not r.profiled
                 and run.in_window(r.t1) and r.sid in waits]
    return sum(less) / len(less) * 1e3 if less else None


def covered_ns(busy, lo: int, hi: int) -> int:
    """ns of [lo, hi) inside the merged intervals ``busy``."""
    k = max(0, bisect.bisect_right(busy, [lo]) - 1)
    out = 0
    for s, e in busy[k:]:
        if s >= hi:
            break
        out += max(0, min(e, hi) - max(s, lo))
    return out


def busy_share(run, name):
    """Of the ``name`` spans that opened under the profiler and closed in
    the window, the share of their time (placed on the trace's clock) that
    the union of device operations covers, in %."""
    if run.trace is None:
        return None
    busy = _union(run.trace.ops)
    covered = total = 0
    for tr, r in closed(run, name, profiled=True):
        lo, hi = tr.to_unix_ns(r.t0), tr.to_unix_ns(r.t1)
        total += hi - lo
        covered += covered_ns(busy, lo, hi)
    return 100.0 * covered / total if total > 0 else None
