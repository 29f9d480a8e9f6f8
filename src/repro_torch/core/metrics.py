"""Goodput / SLO metrics (paper Sec. 4.1), at request and *workflow*
granularity, plus cost-aware variants for the elastic-pool scenario.
A multi-step agentic workflow is good only if every one of its steps
completes and the LAST step finishes within the single per-workflow
deadline — the paper's end-to-end SLO semantics.  Cost metrics bill
every instance from provision to retirement (warmup included), so
goodput-per-dollar is what an operator actually pays for.

Copy of ``repro/core/metrics.py`` (numpy and plain Python),
kept in the port so that it imports nothing of ``repro``.  Its imports
and references name ``repro_torch`` where the reference names
``repro``; any other line that differs carries a comment saying so.
Everything else, float expressions and iteration orders included, is
as written there.
"""
from __future__ import annotations

import math
from array import array
from collections import defaultdict
from typing import Dict, Mapping, Sequence, Tuple


def goodput(finished, total_duration: float) -> float:
    """Average number of requests completing within their E2E-SLO per
    second (paper metric 1)."""
    ok = sum(1 for r in finished
             if r.finished_at is not None
             and (r.finished_at - r.req.arrival) <= r.req.slo)
    return ok / max(total_duration, 1e-9)


def slo_violation_ratio(finished) -> float:
    """Fraction of requests missing their E2E-SLO (paper metric 2);
    unfinished requests count as violations."""
    n = len(finished)
    if n == 0:
        return 0.0
    bad = sum(1 for r in finished
              if r.finished_at is None
              or (r.finished_at - r.req.arrival) > r.req.slo)
    return bad / n


def _group_workflows(finished) -> Dict[int, list]:
    by_wid = defaultdict(list)
    for r in finished:
        if r.req.wid >= 0:
            by_wid[r.req.wid].append(r)
    return by_wid


def workflow_outcomes(finished) -> Dict[int, Tuple[bool, float]]:
    """wid -> (met_deadline, completion_time).  A workflow completes when
    all its steps are done; its completion time is the last step's finish;
    it is good iff that is within the shared absolute deadline."""
    out = {}
    for wid, steps in _group_workflows(finished).items():
        if any(s.finished_at is None for s in steps):
            out[wid] = (False, float("inf"))
            continue
        end = max(s.finished_at for s in steps)
        deadline = max(s.deadline for s in steps)
        out[wid] = (end <= deadline, end)
    return out


def workflow_goodput(finished, total_duration: float) -> float:
    """Workflows finishing within their E2E deadline per second."""
    ok = sum(1 for good, _ in workflow_outcomes(finished).values() if good)
    return ok / max(total_duration, 1e-9)


def workflow_violation_ratio(finished) -> float:
    outcomes = workflow_outcomes(finished)
    if not outcomes:
        return 0.0
    bad = sum(1 for good, _ in outcomes.values() if not good)
    return bad / len(outcomes)


def summarize_workflows(finished, total_duration: float) -> dict:
    outcomes = workflow_outcomes(finished)
    by_wid = _group_workflows(finished)
    makespans = []
    for wid, steps in by_wid.items():
        if all(s.finished_at is not None for s in steps):
            arr = min(s.req.arrival for s in steps)
            makespans.append(max(s.finished_at for s in steps) - arr)
    return {
        "workflow_goodput_wps": workflow_goodput(finished, total_duration),
        "workflow_violation_ratio": workflow_violation_ratio(finished),
        "n_workflows": len(outcomes),
        "n_steps": sum(len(v) for v in by_wid.values()),
        "mean_makespan_s": sum(makespans) / max(len(makespans), 1),
        "migrations": sum(getattr(r, "n_migrations", 0) for r in finished),
        "duration_s": total_duration,
    }


# ---------------------------------------------------------------------------
# Cost-aware goodput (elastic heterogeneous pool)
# ---------------------------------------------------------------------------

def cluster_cost_usd(cluster, duration: float) -> float:
    """Dollars the pool accrued over the run (per-instance $/hr billed
    from ``started_at`` to ``retired_at`` or run end)."""
    return cluster.cost_usd(duration)


def goodput_per_dollar(finished, duration: float, cluster) -> float:
    """SLO-good requests per dollar of pool spend — the quantity elastic
    scaling optimizes (goodput alone rewards overprovisioning)."""
    good = sum(1 for r in finished
               if r.finished_at is not None
               and (r.finished_at - r.req.arrival) <= r.req.slo)
    return good / max(cluster_cost_usd(cluster, duration), 1e-9)


def workflow_goodput_per_dollar(finished, duration: float,
                                cluster) -> float:
    good = sum(1 for ok, _ in workflow_outcomes(finished).values() if ok)
    return good / max(cluster_cost_usd(cluster, duration), 1e-9)


def spot_cost_usd(cluster, duration: float) -> float:
    """The preemptible share of the pool bill (same accrual rule as
    ``cluster.cost_usd``, filtered to spot instances)."""
    return sum(cluster.instance_cost_usd(g, duration)
               for g in cluster.instances if g.hw.is_spot)


def prediction_mae_tokens(finished) -> float:
    """Mean |admission-time output-length belief - actual tokens| over
    requests that produced tokens — the router-side estimation error
    the rectification loop exists to shrink.  Scored at ADMISSION
    (``pred_admit``), not at the last risk check: the mid-flight
    "at least one more token" clamp trivially converges to the truth as
    a request finishes, which would make a non-rectifying router look
    well calibrated exactly when its routing decisions weren't.  NaN
    when no request carries a belief (routers that never predict) —
    "unmeasured" must not read as "perfect"."""
    errs = [abs(r.pred_admit - r.tokens_out) for r in finished
            if getattr(r, "pred_admit", 0.0) > 0.0 and r.tokens_out > 0]
    if not errs:
        return float("nan")
    return sum(errs) / len(errs)


def preemption_violations(finished) -> int:
    """SLO violations among requests a spot eviction touched (evacuated
    in the grace window or killed outright) — the price of the discount,
    which goodput-per-$ must beat."""
    return sum(1 for r in finished
               if getattr(r, "preempted", False)
               and (r.finished_at is None
                    or (r.finished_at - r.req.arrival) > r.req.slo))


def shed_kind(r):
    """How a failed request left the system: "shed" (admission
    rejection), "throttle" (fairness gate), "lost" (capacity died), or
    None (never tagged).  Workflow descendants cancelled by an
    ancestor's rejection carry ``cascade:<tag>`` journey tags and are
    attributed to the same kind — the cascade prefix exists so
    *per-class* accounting can tell a step's own rejection from
    collateral damage, not to hide the root cause here."""
    for _t, ev, _gid in r.journey:
        tag = ev[8:] if ev.startswith("cascade:") else ev
        if tag in ("shed", "throttle", "lost"):
            return tag
    return None


def summarize_elastic(finished, duration: float, cluster) -> dict:
    """Request-level summary extended with pool-cost accounting and
    spot-preemption attribution."""
    s = summarize(finished, duration)
    states = [g.state for g in cluster.instances]
    kinds = [shed_kind(r) for r in finished if r.state == "failed"]
    s.update({
        "cost_usd": cluster_cost_usd(cluster, duration),
        "spot_cost_usd": spot_cost_usd(cluster, duration),
        "goodput_per_usd": goodput_per_dollar(finished, duration, cluster),
        # "shed" = the AdmissionController rejected it; "throttled" =
        # the fairness gate rejected it; "lost" = the pool's capacity
        # died under it (eviction/failure, no survivor)
        "n_shed": sum(1 for k in kinds if k == "shed"),
        "n_throttled": sum(1 for k in kinds if k == "throttle"),
        "n_lost": sum(1 for k in kinds if k not in ("shed", "throttle")),
        "n_instances_total": len(states),
        "n_retired": sum(1 for st in states
                         if st in ("retired", "failed", "evicted")),
        "n_evicted_instances": sum(1 for st in states if st == "evicted"),
        "n_preempted": sum(1 for r in finished
                           if getattr(r, "preempted", False)),
        "preempt_violations": preemption_violations(finished),
        "pred_mae_tokens": prediction_mae_tokens(finished),
        # prefill->decode disaggregation transfers (role-split pools;
        # always 0 in flat pools)
        "n_handoffs": sum(getattr(r, "n_handoffs", 0) for r in finished),
    })
    return s


# ---------------------------------------------------------------------------
# Multi-tenant / SLO-class accounting
# ---------------------------------------------------------------------------

def _cell():
    return {"n": 0, "good": 0, "violations": 0, "shed": 0,
            "throttled": 0, "lost": 0, "cascaded": 0}


def _tally(cell, r):
    cell["n"] += 1
    if (r.finished_at is not None
            and (r.finished_at - r.req.arrival) <= r.req.slo):
        cell["good"] += 1
    else:
        cell["violations"] += 1
    if r.state == "failed":
        cascaded = any(ev.startswith("cascade:") for _t, ev, _g in r.journey)
        if cascaded:
            cell["cascaded"] += 1
        kind = shed_kind(r)
        if kind == "shed":
            cell["shed"] += 1
        elif kind == "throttle":
            cell["throttled"] += 1
        else:
            cell["lost"] += 1


def per_class_breakdown(finished, total_duration: float) -> dict:
    """slo_class -> outcome accounting, each request attributed to its
    OWN class (cascade journey tags keep collateral cancellations from
    being blamed on the root's class).  Unclassed requests group under
    "".  ``goodput_rps`` per class shares the run's duration so class
    rows are comparable to the aggregate."""
    out: Dict[str, dict] = {}
    for r in finished:
        _tally(out.setdefault(r.req.slo_class, _cell()), r)
    for cell in out.values():
        cell["goodput_rps"] = cell["good"] / max(total_duration, 1e-9)
    return dict(sorted(out.items()))


def per_tenant_breakdown(finished, total_duration: float) -> dict:
    """tenant id -> the same outcome accounting, plus the tokens the
    pool actually processed for the tenant (prompt + generated of every
    request that produced output) — the service measure a fairness
    scheduler's ledger must conserve.  Anonymous traffic is tenant -1."""
    out: Dict[int, dict] = {}
    for r in finished:
        cell = out.setdefault(r.req.tenant, _cell())
        _tally(cell, r)
        if r.state == "done":
            cell["served_tokens"] = (cell.get("served_tokens", 0)
                                     + r.req.input_len + r.tokens_out)
    for cell in out.values():
        cell.setdefault("served_tokens", 0)
        cell["goodput_rps"] = cell["good"] / max(total_duration, 1e-9)
    return dict(sorted(out.items()))


# ---------------------------------------------------------------------------
# Decision latency (control-plane overhead, paper Fig. 11 budget)
# ---------------------------------------------------------------------------

class LatencyLog:
    """Wall-clock decision latency of the control plane, per event
    kind ("arrival", "tick", ...).  This measures only the plane's own
    compute — the time a hook spends producing its next decision, not
    the simulated actuation — so it is directly comparable to the
    paper's Fig. 11 per-request routing-overhead budget.

    Samples are wall-clock and therefore nondeterministic by nature;
    they live OUTSIDE every replay fingerprint (decision logs and
    metric summaries never include them).  Storage is ``array('d')``
    so million-event traces cost 8 bytes per sample, not a boxed
    float."""

    def __init__(self):
        self.samples: Dict[str, array] = {}

    def record(self, kind: str, seconds: float):
        a = self.samples.get(kind)
        if a is None:
            a = self.samples[kind] = array("d")
        a.append(seconds)

    def merge(self, other: "LatencyLog") -> "LatencyLog":
        """Fold another log into this one (e.g. per-replica logs of a
        sharded plane into a gateway-wide distribution)."""
        for kind, a in other.samples.items():
            mine = self.samples.get(kind)
            if mine is None:
                mine = self.samples[kind] = array("d")
            mine.extend(a)
        return self

    def n(self) -> int:
        return sum(len(a) for a in self.samples.values())

    def summary(self) -> dict:
        return summarize_decision_latency(self.samples)


def _percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile of an ascending-sorted sequence."""
    if not sorted_vals:
        return 0.0
    rank = math.ceil(q / 100.0 * len(sorted_vals))
    return sorted_vals[min(max(rank, 1), len(sorted_vals)) - 1]


def summarize_decision_latency(samples_by_kind: Mapping[str, Sequence[float]]
                               ) -> dict:
    """Per-event-kind latency distribution in microseconds:
    ``kind -> {n, mean_us, p50_us, p95_us, p99_us, max_us}``."""
    out = {}
    for kind, vals in sorted(samples_by_kind.items()):
        s = sorted(vals)
        if not s:
            continue
        out[kind] = {
            "n": len(s),
            "mean_us": sum(s) / len(s) * 1e6,
            "p50_us": _percentile(s, 50.0) * 1e6,
            "p95_us": _percentile(s, 95.0) * 1e6,
            "p99_us": _percentile(s, 99.0) * 1e6,
            "max_us": s[-1] * 1e6,
        }
    return out


def summarize(finished, total_duration: float) -> dict:
    lat = [(r.finished_at - r.req.arrival) for r in finished
           if r.finished_at is not None]
    return {
        "goodput_rps": goodput(finished, total_duration),
        "violation_ratio": slo_violation_ratio(finished),
        "n": len(finished),
        "n_finished": len(lat),
        "mean_latency_s": sum(lat) / max(len(lat), 1),
        "migrations": sum(getattr(r, "n_migrations", 0) for r in finished),
        "duration_s": total_duration,
    }
