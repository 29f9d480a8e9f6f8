"""One run of one cell: set-up, the measured window, the metrics, the
check.  ``run.py`` is the command; tests drive ``run_cell`` on the CPU at
a reduced size."""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import time
from typing import List, Optional

import numpy as np
import torch

from pb import check, program, spec, weights as wts
from pb.counts import Counts
from pb.loop import Loop, Tracked
from pb.trace import Span, TraceSummary
from pb.traffic import Traffic

TRACE_SPAN_S = 8.0          # the traced span: the window's last seconds
JAX_NAMES = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class RunRecord:
    """What a run saw; the metric readers take their numbers from it."""
    cell: spec.Cell
    counts: Counts
    loop: Loop
    t_w: float
    t_end: float
    setup_s: float
    trace: Optional[TraceSummary] = None

    @property
    def window_s(self) -> float:
        return self.t_end - self.t_w

    def in_window(self, t: float) -> bool:
        return self.t_w <= t < self.t_end

    def due_in_window(self) -> List[Tracked]:
        return [tr for tr in self.loop.tracked if self.in_window(tr.due)]

    def events(self, kind: Optional[str] = None) -> List[tuple]:
        return [e for e in self.loop.events if self.in_window(e[4])
                and (kind is None or e[1] == kind)]

    def steps(self, traced: bool = False):
        return [s for s in self.loop.steps if self.in_window(s.t)
                and (s.traced or not traced)]


@dataclasses.dataclass
class Outcome:
    record: RunRecord
    metrics: dict
    compared: dict
    correct: bool
    attempted: int
    failed: int
    memory_peak: int
    notes: dict


def _loaded_jax():
    import sys
    return sorted({m.split(".")[0] for m in sys.modules} & set(JAX_NAMES))


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float, fault=None, check_mode: str = "fp32",
             judge: bool = True):
    """Serve ``cell`` for ``seconds`` after its set-up; ``t_start`` is
    when the process started (set-up counts from there).  ``fault``, for
    tests, is called with the engines before the traffic starts."""
    conf, dev = cell.config, torch.device(device)
    serving = conf["serving"]
    dtype = program.DTYPES[serving["dtype"]]
    cfg = program.model_config(conf)
    ref = spec.reference(conf, cell.bench_dir)
    lay = program.layout(cfg, dtype)
    leaves = ref.leaves(conf, lay["top.embed"][0][0])
    marks = {"imports_s": time.perf_counter() - t_start}
    t = time.perf_counter()
    weights = wts.draw(leaves, seed, lay, dev)
    wts.zero_padding(weights, leaves, conf["vocab_size"])
    model = program.build_model(cfg, weights, dtype)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    marks["weights_s"] = time.perf_counter() - t
    t = time.perf_counter()
    engines = program.build_engines(cfg, model, serving, dev)
    marks["engines_s"] = time.perf_counter() - t
    if fault is not None:
        fault(engines)
    counts = Counts.of(conf)
    traffic = Traffic(cell.traffic, cell.settings, conf, seed, seconds,
                      serving["max_len"])
    loop = Loop(engines, traffic, counts.flash_layers())
    loop.start()
    # a mix that starts mid-session warms until its first round is in
    first = (set(id(r) for r in traffic.requests[:traffic.clients])
             if cell.traffic.get("first_round") else set())
    warm = traffic.warmup_s

    def warmed(now):
        if now < loop.t0 + warm:
            return False
        return sum(tr.n > 0 for tr in loop.tracked
                   if id(tr.req) in first) == len(first)
    t = time.perf_counter()
    loop.run_until(warmed)
    gc.collect()
    gc.freeze()             # set-up's objects out of the collector's way
    t_w = loop.clock()
    marks["warm_s"] = t_w - t
    setup_s = t_w - t_start
    span = None
    if trace and dev.type == "cuda":
        span = Span()
        loop.run_until(lambda now: now >= t_w + max(0.0, seconds
                                                    - TRACE_SPAN_S))
        span.start(loop.clock())
        loop.tracing = True
        loop.annotate = torch.profiler.record_function
        loop.run_until(lambda now: now >= t_w + seconds)
        t_end = loop.clock()
        loop.tracing = False
        loop.annotate = lambda name: contextlib.nullcontext()
        span.stop(t_end)
    else:
        loop.run_until(lambda now: now >= t_w + seconds)
        t_end = loop.clock()
    if traffic.open and traffic.drain_s:
        def resolved(now):
            return now >= t_end + traffic.drain_s or all(
                tr.done_t is not None or now > tr.deadline
                for tr in loop.tracked if t_w <= tr.due < t_end)
        loop.run_until(resolved)
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    notes_names = {f"engine{g}.step" for g in range(len(engines))} | {
        "harness.submit", "harness.idle"}
    rec = RunRecord(cell, counts, loop, t_w, t_end, setup_s,
                    span.reduce(notes_names) if span else None)
    metrics_list = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in metrics_list:
        value = spec.metric_reader(m.name, cell.bench_dir).read(rec)
        if value is not None:
            metrics[m.name] = {"value": float(value), "unit": m.unit}
    if traffic.open:
        counted = rec.due_in_window()
    else:
        counted = [tr for tr in loop.tracked if rec.in_window(tr.sent)]
    failed = sum(tr in loop.failed for tr in counted)
    notes = {"setup_parts": marks,
             "capture_s": [e.capture_s for e in engines],
             "submitted_late_p90_ms": _late_p90(counted),
             "clipped_outputs": traffic.clipped,
             "drained_unresolved": sum(
                 1 for tr in rec.due_in_window() if tr.done_t is None)
             if traffic.open else 0}
    # the check: the program's state freed first, the weights kept
    del engines, model
    loop.engines = []
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if not judge:
        return Outcome(rec, metrics, {}, False, len(counted), failed,
                       memory_peak, notes), weights, []
    t_check = time.perf_counter()
    chosen = check.sample(loop.tracked, t_end, seed,
                          serving["engines"], cell.settings["check_tokens"])
    stats = {}
    g, ctl = check.gaps(conf, ref, weights, chosen, check_mode == "fp8",
                        stats)
    if check_mode == "fp8":        # the control in the program's place
        g, ctl = ctl, g
    n_tok = int(g.numel())
    read = {"logit_gap": float(g.max()) if n_tok else math.inf,
            "logit_gap_mean": float(g.double().mean()) if n_tok
            else math.inf}
    limits = cell.settings["limits"]
    compared = {k: {"value": read[k], "limit": limits[k]} for k in read
                if k in limits}
    compared["tokens_checked"] = {"value": n_tok,
                                  "limit": cell.settings["check_tokens"]}
    correct = all(read[k] <= limits[k] for k in read if k in limits) and \
        n_tok >= cell.settings["check_tokens"]
    notes.update(check_s=time.perf_counter() - t_check,
                 requests_checked=len(chosen),
                 gap_stats=check.stats(g),
                 other_gap_stats=check.stats(ctl) if ctl is not None
                 else None,
                 engines_checked=sorted({tr.engine for tr in chosen}),
                 moe_pairs_dropped=stats.get("dropped"))
    return Outcome(rec, metrics, compared, correct, len(counted), failed,
                   memory_peak, notes), weights, chosen


def _late_p90(counted) -> float:
    late = [tr.sent - tr.due for tr in counted]
    return float(np.percentile(late, 90) * 1e3) if late else 0.0
