"""A bounded span of the window under ``torch.profiler``, reduced in
memory: every device operation's interval, the union of them (busy
time), the operations that took most time, and the idle gaps labelled
with what the host was doing in them.  Nothing is written to disk."""
from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import List, Tuple

import torch

GAP_LABEL_US = 20.0        # gaps shorter than this are labelled together


@dataclasses.dataclass
class TraceSummary:
    ops: List[Tuple[str, int, int]]     # (name, start ns, duration ns)
    window_s: float
    busy_s: float
    device_ops: List[list]
    idle_gaps: List[list]

    def time_of(self, match) -> float:
        """Device seconds of the operations whose name ``match`` accepts."""
        return sum(d for n, _, d in self.ops if match(n)) / 1e9


class Span:
    def __init__(self):
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.t0 = self.t1 = 0.0

    def start(self, now: float):
        torch.cuda.synchronize()
        self.prof.start()
        self.t0 = now

    def stop(self, now: float):
        torch.cuda.synchronize()
        self.t1 = now
        self.prof.stop()

    def reduce(self, notes=frozenset()) -> TraceSummary:
        """``notes``: the names of the harness's annotations."""
        dev, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            kind = e.device_type()
            if kind == torch.autograd.DeviceType.CUDA:
                # the harness's annotations are mirrored on the device's
                # timeline; they are spans, not operations
                if not (e.is_user_annotation() or e.name() in notes):
                    dev.append((e.name(), e.start_ns(), e.duration_ns()))
            elif kind == torch.autograd.DeviceType.CPU:
                host.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                             e.name(), e.is_user_annotation()))
        return summarize(dev, host, self.t1 - self.t0)


def _union(ops):
    """Merged busy intervals [(start, end)] of device operations."""
    out = []
    for _, s, d in sorted(ops, key=lambda o: o[1]):
        e = s + d
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _host_label(host, starts, t: int) -> str:
    """The user annotation and the innermost host event around time t."""
    k = bisect.bisect_right(starts, t)
    inner = note = None
    for j in range(k - 1, max(-1, k - 4000), -1):
        s, e, name, is_note = host[j]
        if e >= t:
            if is_note:
                note = note or name
            elif inner is None:
                inner = name
            if note and inner:
                break
    return f"{note or 'host'}/{inner or 'python'}"


def summarize(dev, host, window_s: float) -> TraceSummary:
    busy = _union(dev)
    busy_s = sum(e - s for s, e in busy) / 1e9
    by_name = defaultdict(int)
    for n, _, d in dev:
        by_name[n[:96]] += d
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    host = sorted(host)
    starts = [h[0] for h in host]
    gaps = defaultdict(int)
    for (s0, e0), (s1, _) in zip(busy, busy[1:]):
        g = s1 - e0
        if g <= 0:
            continue
        if g < GAP_LABEL_US * 1e3:
            gaps[f"gaps under {GAP_LABEL_US:g} us"] += g
        else:
            gaps[_host_label(host, starts, (e0 + s1) // 2)] += g
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return TraceSummary(dev, window_s, busy_s,
                        [[n, d / 1e9] for n, d in top],
                        [[n, d / 1e9] for n, d in idle])
