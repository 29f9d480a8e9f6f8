"""Arithmetic the metric readers share: percentiles, the window's tokens,
event sums, model flops and the kernels' bounds over the traced span."""
from __future__ import annotations

import re

import numpy as np

from pb.counts import PEAK_FLOPS, bound_s

# the port's kernels, by the names its sources give them
FLASH = re.compile(r"\(anonymous namespace\)::flash_\w*kernel")
PAGED = re.compile(r"\(anonymous namespace\)::paged_\w*kernel")


def p90(values):
    return float(np.percentile(values, 90)) if len(values) else None


def tokens_in_window(run, tr):
    """(count, first time, last time) of tr's tokens inside the window."""
    n, first, last = 0, None, None
    for t, k in tr.times:
        if run.in_window(t):
            n += k
            first = t if first is None else first
            last = t
    return n, first, last


def event_sum(run, kind):
    ev = run.events(kind)
    return sum(e[3] for e in ev), ev


def decode_flops(run):
    return sum(run.counts.decode_flops(s.ctxs) for s in run.steps()
               if s.ctxs)


def prefill_flops(run):
    """Model flops of the prefills whose events closed in the window."""
    return sum(run.counts.prefill_flops(e[2]) for e in run.events("prefill"))


def mfu(flops, seconds):
    return 100.0 * flops / (seconds * PEAK_FLOPS) if seconds > 0 else None


def roofline(run, pattern, calls_of):
    """Σ bound / Σ device time of the kernels matching ``pattern`` over the
    traced span, with ``calls_of(step)`` the (flops, bytes) of each of its
    calls; None without a trace or without such a kernel in it."""
    tr = run.trace
    if tr is None:
        return None
    dev_s = tr.time_of(lambda n: pattern.search(n) is not None)
    if dev_s <= 0:
        return None
    bound = sum(bound_s(f, b) for s in run.steps(traced=True)
                for f, b in calls_of(s))
    return 100.0 * bound / dev_s


def idle_share(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def time_average(samples, t0: float, t1: float):
    """Time average over [t0, t1] of a step function sampled as (time,
    value), each value holding until the next sample."""
    area = 0.0
    for (t, v), (t_next, _) in zip(samples, samples[1:]):
        lo, hi = max(t, t0), min(t_next, t1)
        if hi > lo:
            area += v * (hi - lo)
    return area / (t1 - t0) if t1 > t0 else None
