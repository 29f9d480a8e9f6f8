"""Declarative experiment harness: one spec, one runner.

Copy of ``repro/bench/harness.py`` (numpy and plain Python),
kept in the port so that it imports nothing of ``repro``.  Its imports
and references name ``repro_torch`` where the reference names
``repro``; any other line that differs carries a comment saying so.
Everything else, float expressions and iteration orders included, is
as written there.

Every scenario benchmark used to hand-wire the same ~200 lines: build a
workload, build a cluster, build router + controller + admission, thread
them through ``Simulator``, time the run, recompute goodput over the
shared arrival span, cost, goodput-per-dollar...  A figure is really
just (pool, workload, plane, seeds) plus its assertions — so that is
what :class:`ExperimentSpec` declares, and :func:`run_experiment` does
the rest through the :class:`~repro_torch.core.control_plane.ControlPlane`
API.

Spec fields are FACTORIES, not instances: policies attach exactly once,
so every seed (and every configuration) must get a fresh plane.  The
workload factory takes the seed; the plane factory takes the freshly
built cluster (some policies — oracle rate tables — are derived from
it).

    spec = ExperimentSpec(
        name="fig14_spot_aware_goodserve",
        pool=lambda: Cluster([...]),
        workload=lambda seed: make_workload(n=2200, seed=seed, ...),
        plane=lambda cluster: ControlPlane(
            router=GoodServeRouter(beliefs=b),
            pool=ReactivePoolController(...),
            admission=AdmissionController(beliefs=b)),
        seeds=(4,),
        sim_kw=dict(spot_seed=16))
    result = run_experiment(spec)[0]
    assert result.summary["goodput_per_usd"] > ...

The summary carries ``summarize_elastic`` (plus ``goodput_rps`` /
``goodput_per_usd`` recomputed over the shared *arrival span*, so
run-duration tails cannot distort cross-configuration comparisons, and
``n_eviction_notices``), or ``summarize_workflows`` when the workload
factory returns ``(requests, workflows)``.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

from repro_torch.cluster.simulator import Cluster, Simulator
from repro_torch.core.control_plane import ControlPlane
from repro_torch.core.metrics import summarize_elastic, summarize_workflows


@dataclasses.dataclass
class ExperimentSpec:
    """One benchmark configuration, declaratively.

    * ``name``     — row label (figure_mode_router by convention),
    * ``pool``     — cluster factory: () -> Cluster,
    * ``workload`` — trace factory: seed -> requests, or
      (requests, workflows) for DAG traces,
    * ``plane``    — control-plane factory: cluster -> ControlPlane
      (a bare router Policy is accepted and wrapped),
    * ``seeds``    — one run per seed,
    * ``sim_kw``   — extra Simulator knobs (tau, spot_seed,
      preemptions, fail_at, ...),
    * ``summarize`` — optional override: (out, dur, cluster) -> dict
      replaces the default elastic/workflow summary entirely,
    * ``train``    — optional trainable-policy hook: () -> artifact,
      called ONCE before the seed loop (offline training on a logged
      DecisionTrace, a fitted posterior, ...); when set, the plane
      factory is called as ``plane(cluster, artifact)`` so every seed's
      fresh policies warm-start from the SAME trained state.
    """
    name: str
    pool: Callable[[], Cluster]
    workload: Callable[[int], Any]
    plane: Callable[..., Any]
    seeds: Sequence[int] = (0,)
    sim_kw: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    summarize: Optional[Callable] = None
    train: Optional[Callable[[], Any]] = None


@dataclasses.dataclass
class ExperimentResult:
    """One run's outcome plus the handles a figure may want to probe
    (learned posteriors, journeys, controller event logs, the decision
    log)."""
    name: str
    seed: int
    summary: Dict[str, Any]
    requests: list                  # SimRequests, post-run
    workflows: Optional[list]
    duration: float
    us: float                       # wall-clock microseconds of sim.run
    cluster: Cluster
    plane: ControlPlane
    sim: Simulator

    @property
    def router(self):
        return self.plane.router


def _summarize(out, dur, cluster, reqs, span, workflows):
    if workflows is not None:
        return summarize_workflows(out, dur)
    s = summarize_elastic(out, dur, cluster)
    # goodput over the shared arrival span: run-duration tails (one
    # straggler request) must not distort cross-config comparisons
    good = sum(1 for r in out if r.finished_at is not None
               and (r.finished_at - r.req.arrival) <= r.req.slo)
    s["goodput_rps"] = good / span
    s["goodput_per_usd"] = good / max(s["cost_usd"], 1e-9)
    return s


def aggregate_results(results: Sequence[ExperimentResult],
                      keys: Sequence[str] = ("goodput_rps",
                                             "goodput_per_usd")) -> dict:
    """Cross-seed aggregation: per summary key, the sample mean and a
    normal-approximation 95% confidence half-width
    (``1.96 * s / sqrt(n)`` with the ddof=1 sample standard deviation;
    0.0 when only one seed ran — a single run has no spread to report,
    which is exactly why multi-seed specs exist).  Learned-vs-heuristic
    comparisons are only meaningful with error bars (Lodestar)."""
    out = {}
    for key in keys:
        vals = [float(r.summary[key]) for r in results]
        n = len(vals)
        if n == 0:
            raise ValueError(f"no results to aggregate for {key!r}")
        mean = sum(vals) / n
        if n > 1:
            var = sum((v - mean) ** 2 for v in vals) / (n - 1)
            ci95 = 1.96 * math.sqrt(var / n)
        else:
            ci95 = 0.0
        out[key] = {"mean": mean, "ci95": ci95, "n": n}
    return out


class ResultList(list):
    """``run_experiment``'s return value: a list of per-seed
    ExperimentResults (so every existing ``run_experiment(spec)[0]``
    caller keeps working) that also knows how to aggregate itself."""

    def aggregate(self, keys: Sequence[str] = ("goodput_rps",
                                               "goodput_per_usd")) -> dict:
        return aggregate_results(self, keys)


def run_experiment(spec: ExperimentSpec) -> "ResultList":
    """Build, run, and summarize one spec — once per seed."""
    results = ResultList()
    trained = spec.train() if spec.train is not None else None
    for seed in spec.seeds:
        wl = spec.workload(seed)
        reqs, wfs = wl if isinstance(wl, tuple) else (wl, None)
        # workflow steps' arrival fields are rewritten at release time;
        # take the span before the run
        span = max((r.arrival for r in reqs), default=1.0)
        cluster = spec.pool()
        plane = (spec.plane(cluster, trained)
                 if spec.train is not None else spec.plane(cluster))
        if not isinstance(plane, ControlPlane):
            plane = ControlPlane(router=plane)
        sim = Simulator(cluster, plane, reqs, workflows=wfs,
                        **dict(spec.sim_kw))
        t0 = time.perf_counter()
        out, dur = sim.run()
        us = (time.perf_counter() - t0) * 1e6
        if spec.summarize is not None:
            s = dict(spec.summarize(out, dur, cluster))
        else:
            s = _summarize(out, dur, cluster, reqs, span, wfs)
        s["n_eviction_notices"] = len(sim.eviction_log)
        results.append(ExperimentResult(
            name=spec.name, seed=seed, summary=s, requests=out,
            workflows=wfs, duration=dur, us=us, cluster=cluster,
            plane=plane, sim=sim))
    return results
