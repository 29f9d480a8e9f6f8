"""Counterfactual replay: logged decision traces, what-if re-execution,
and doubly-robust off-policy evaluation.

Copy of ``repro/core/replay.py`` (numpy and plain Python),
kept in the port so that it imports nothing of ``repro``.  Its imports
and references name ``repro_torch`` where the reference names
``repro``; any other line that differs carries a comment saying so.
Everything else, float expressions and iteration orders included, is
as written there.

The plane's ``decision_log``/``executed_log`` prove a run is
replayable; this module makes the log a *training and evaluation
artifact*.  Three pieces:

**DecisionTrace** — a schema-versioned JSON artifact recording one run's
arrivals (full ``Request`` fields, serialized before the run mutates
workflow release times), one event per arrival decision with the frozen
per-candidate ``ClusterView`` features the gateway saw (queue depth,
EMA capability, rectified remaining work, believed eviction rate,
region placement), the decision itself (route target / shed / park)
with the logging policy's *propensity* for the chosen arm, and the
realized terminal outcome (latency, deadline met, tokens streamed,
per-request goodput reward — zero-reward for every terminal failure:
shed, cascade, lost, so learners never silently drop failed arms).

**TraceRecorder** — the plane-side hook behind ``ControlPlane(record=)``.
Recording is decision-neutral by construction: features are captured
with :func:`~repro_torch.core.observability.capture_instance` (no snapshot
version bump), nothing on the request or the policies is mutated, and a
recorded run replays byte-identical to an unrecorded one.

**replay_whatif / dr_estimate** — the two evaluation modes.
``replay_whatif(trace, plane_factory, pool_factory)`` re-executes the
logged arrivals in the full simulator under a *different* policy (same
requests, same pool factory, same sim knobs — recorded in the trace),
so counterfactual interference is fully modeled.  ``dr_estimate(trace,
policy)`` scores a candidate policy *without* re-simulating: the
doubly-robust estimator over the logged propensities of an
epsilon-greedy logging policy — direct-model value of the candidate's
arm, plus an importance-weighted correction on events where the
candidate agrees with the logged action.  Candidates only need an
``offline_choose(event) -> iid`` method over the trace's frozen
features (:class:`~repro_torch.core.learned_router.BanditRouter` implements
it; :class:`JustEnoughOfflinePolicy` is the heuristic surrogate).

Proxy-visibility: every recorded feature comes from InstanceView
scalars, the shared Beliefs bundle, or client-declared request fields —
this module is on the observability source-scan list.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.observability import InstanceView, capture_instance

SCHEMA_VERSION = 1

# The canonical per-candidate feature vector, shared verbatim by the
# recorder, the BanditRouter's live routing, and the offline estimators
# (warm-start and DR scoring must see exactly the features live routing
# saw).  All entries are proxy-visible and roughly unit-scaled.
FEATURE_NAMES = (
    "bias",          # 1.0
    "queue_depth",   # queued requests / 8
    "slot_frac",     # running / engine admission cap
    "wait_s",        # EMA queue-wait estimate (s)
    "prefill_s",     # EMA per-token prefill x prompt length (s)
    "decode_s",      # EMA TPOT x rectified remaining work (s)
    "pressure",      # (wait + prefill + decode) / deadline slack, clipped
    "evict_rpm",     # believed eviction rate (per minute), spot only
    "cross_region",  # 1.0 when serving leaves the request's origin region
)
FEATURE_DIM = len(FEATURE_NAMES)

# remaining-work scale used when the plane has no length predictor —
# shared by the recorder's features and BanditRouter's live routing so
# the two never disagree on a predictor-less plane
DEFAULT_PRED = 128.0

_EVENT_KEYS = ("t", "rid", "kind", "gid", "propensity", "context",
               "candidates", "outcome")
_KINDS = ("route", "shed", "park")


def load_bucket(pending: int) -> int:
    """Quantized instance load — the bandit's context key alongside the
    hardware type (arms generalize across instances of one type at one
    load level, and transfer to elastically provisioned newcomers)."""
    return min(int(pending) // 3, 3)


def feature_vector(v: InstanceView, input_len: int, pred_remaining: float,
                   slack: float, evict_rph: float,
                   req_region: str) -> List[float]:
    """The canonical feature vector for one candidate instance view."""
    wait = float(v.ema.q)
    prefill = float(v.ema.p) * float(input_len)
    decode = float(v.ema.d) * max(float(pred_remaining), 1.0)
    pressure = (wait + prefill + decode) / max(float(slack), 1e-3)
    cross = 1.0 if (req_region and v.region != req_region) else 0.0
    return [1.0,
            v.n_queued / 8.0,
            v.n_running / max(v.hw.max_seqs, 1),
            wait,
            prefill,
            decode,
            min(pressure, 4.0),
            (float(evict_rph) / 60.0) if v.is_spot else 0.0,
            cross]


def candidate_record(v: InstanceView, sr, t: float, beliefs,
                     pred: Optional[float] = None) -> dict:
    """One candidate's frozen trace entry: identity, arm key, features."""
    if pred is None:
        pred = beliefs.predict(sr)
    slack = sr.deadline - t
    rate = beliefs.rate_per_hour(v.hw.name) if v.is_spot else 0.0
    return {"iid": int(v.iid),
            "hw": v.hw.name,
            "bucket": load_bucket(v.pending),
            "x": feature_vector(v, sr.req.input_len, pred, slack, rate,
                                sr.req.region)}


# ---------------------------------------------------------------------------
# The artifact
# ---------------------------------------------------------------------------

_TUPLE_FIELDS = ("parents", "prefix_chain")


def serialize_request(r) -> dict:
    """JSON-safe dict of one workload Request (numpy scalars coerced)."""
    d = dataclasses.asdict(r)
    for k, v in d.items():
        if isinstance(v, np.integer):
            d[k] = int(v)
        elif isinstance(v, np.floating):
            d[k] = float(v)
        elif isinstance(v, tuple):
            d[k] = [int(x) for x in v]
    return d


def serialize_requests(sim_requests) -> List[dict]:
    """Pre-run snapshot of every arrival (workflow steps' ``arrival`` is
    rewritten at release time, so this must run at attach, not after)."""
    return [serialize_request(sr.req) for sr in sim_requests]


def sim_kw_of(sim) -> dict:
    """The Simulator knobs a faithful re-execution needs."""
    return {"tau": int(sim.tau),
            "migration_mode": sim.migration_mode,
            "fail_at": {int(k): float(v) for k, v in sim.fail_at.items()},
            "max_time": float(sim.max_time),
            "preemptions": bool(sim.preemptions),
            "spot_seed": int(sim.spot_seed),
            "tick_s": float(sim.tick_s)}


@dataclasses.dataclass
class DecisionTrace:
    """One recorded run: arrivals + per-decision features/propensities +
    realized outcomes, versioned for on-disk durability."""
    requests: List[dict] = dataclasses.field(default_factory=list)
    sim_kw: dict = dataclasses.field(default_factory=dict)
    events: List[dict] = dataclasses.field(default_factory=list)
    meta: dict = dataclasses.field(default_factory=dict)
    schema_version: int = SCHEMA_VERSION

    # -- (de)serialization ---------------------------------------------------

    def to_json(self) -> str:
        return json.dumps({"schema_version": self.schema_version,
                           "meta": self.meta,
                           "sim_kw": self.sim_kw,
                           "requests": self.requests,
                           "events": self.events})

    @classmethod
    def from_json(cls, text: str) -> "DecisionTrace":
        try:
            d = json.loads(text)
        except json.JSONDecodeError as e:
            raise ValueError(f"malformed DecisionTrace artifact: {e}")
        return cls.from_dict(d)

    @classmethod
    def from_dict(cls, d) -> "DecisionTrace":
        _validate(d)
        return cls(requests=d["requests"], sim_kw=d.get("sim_kw", {}),
                   events=d["events"], meta=d.get("meta", {}),
                   schema_version=d["schema_version"])

    def save(self, path: str):
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "DecisionTrace":
        with open(path) as f:
            return cls.from_json(f.read())

    # -- consumption ---------------------------------------------------------

    def requests_objects(self) -> list:
        """Rebuild the workload Requests for re-execution."""
        from repro_torch.cluster.workload import Request
        out = []
        for d in self.requests:
            kw = dict(d)
            for k in _TUPLE_FIELDS:
                kw[k] = tuple(kw.get(k) or ())
            out.append(Request(**kw))
        return out

    def sim_kwargs(self) -> dict:
        """Recorded Simulator knobs, JSON artifacts healed (string
        fail_at keys back to instance ids)."""
        kw = dict(self.sim_kw)
        if "fail_at" in kw:
            kw["fail_at"] = {int(k): float(v)
                             for k, v in kw["fail_at"].items()}
        return kw

    def route_events(self) -> List[dict]:
        """Routed arrivals with a settled outcome — the training and
        off-policy-evaluation sample."""
        return [e for e in self.events
                if e["kind"] == "route" and e.get("outcome")]

    @classmethod
    def merge(cls, traces: Sequence["DecisionTrace"],
              requests: Optional[List[dict]] = None,
              sim_kw: Optional[dict] = None) -> "DecisionTrace":
        """Fold per-replica traces (sharded gateway: each replica records
        only the arrivals it owns) into one stream ordered by event time,
        ties by request id — a deterministic global order regardless of
        replica count."""
        events = sorted((e for tr in traces for e in tr.events),
                        key=lambda e: (e["t"], e["rid"]))
        reqs = requests
        kw = sim_kw
        meta: dict = {}
        for tr in traces:
            if reqs is None and tr.requests:
                reqs = tr.requests
            if kw is None and tr.sim_kw:
                kw = tr.sim_kw
            meta.update(tr.meta)
        return cls(requests=reqs or [], sim_kw=kw or {}, events=events,
                   meta=meta)


def _validate(d):
    if not isinstance(d, dict):
        raise ValueError("malformed DecisionTrace artifact: not an object")
    if d.get("schema_version") != SCHEMA_VERSION:
        raise ValueError(
            f"DecisionTrace schema_version {d.get('schema_version')!r} "
            f"!= supported {SCHEMA_VERSION}")
    for key in ("requests", "events"):
        if not isinstance(d.get(key), list):
            raise ValueError(f"malformed DecisionTrace artifact: "
                             f"{key!r} missing or not a list")
    for e in d["events"]:
        missing = [k for k in _EVENT_KEYS if k not in e]
        if missing:
            raise ValueError(f"malformed DecisionTrace event: "
                             f"missing keys {missing}")
        if e["kind"] not in _KINDS:
            raise ValueError(f"malformed DecisionTrace event: "
                             f"unknown kind {e['kind']!r}")


# ---------------------------------------------------------------------------
# The recorder (plane-side, behind ControlPlane(record=...))
# ---------------------------------------------------------------------------

class TraceRecorder:
    """Records one plane's arrival decisions and terminal outcomes.

    Bound by ``ControlPlane.attach``; a replica plane attached to a
    sharded gateway's context (no ``requests`` surface) records events
    only — the sharded plane supplies arrivals and sim knobs when it
    merges the per-replica streams.

    Propensity contract: after routing, the recorder reads the router's
    ``last_decision_info`` (set per decision by stochastic policies:
    ``{"rid", "propensity", "greedy_gid"}``).  Deterministic policies
    set nothing and log propensity 1.0 — their behavior policy puts all
    mass on the chosen arm.
    """

    def __init__(self):
        self.requests: List[dict] = []
        self.sim_kw: dict = {}
        self.meta: dict = {}
        self.events: List[dict] = []
        self._by_rid: Dict[int, dict] = {}

    def bind(self, plane, sim):
        """Adopt the run: snapshot arrivals and sim knobs pre-run (a
        replica context exposes no requests — events only)."""
        reqs = getattr(sim, "requests", None)
        if reqs is not None:
            self.requests = serialize_requests(reqs)
            self.sim_kw = sim_kw_of(sim)
        self.meta.setdefault("router", getattr(plane.router, "name", "?"))

    # -- candidate capture ---------------------------------------------------

    def _views(self, plane, t: float):
        """The admission-routing candidate set, mirrored from the router
        base's target selection: accepting instances, prefill-capable
        preferred in role-split pools.  Uses ``capture_instance`` (not a
        full ClusterView capture) so recording never bumps the snapshot
        version counter; a replica's frozen snapshot surface already
        holds InstanceViews and is used as-is."""
        insts = list(plane.cluster.instances)
        if insts and isinstance(insts[0], InstanceView):
            views = insts
        else:
            cluster = plane.cluster
            views = [capture_instance(cluster, g, t) for g in insts]
        acc = [v for v in views if v.accepting]
        pf = [v for v in acc if v.can_prefill]
        return pf or acc

    # -- hooks (driven by the plane) -----------------------------------------

    def record_arrival(self, plane, sr, t: float, decision):
        """One arrival's frozen decision record (first admission only —
        later resubmissions of the same request are rescue mechanics,
        not logged-bandit context)."""
        rid = int(sr.req.rid)
        if rid in self._by_rid:
            return
        from repro_torch.core import control_plane as cplib
        if isinstance(decision, cplib.Route):
            kind, gid, reason = "route", int(decision.gid), ""
        elif isinstance(decision, cplib.Shed):
            kind, gid, reason = "shed", -1, decision.reason
        else:
            kind, gid, reason = "park", -1, ""
        beliefs = plane.beliefs
        # baseline routers run without a length predictor; the features
        # still need a remaining-work scale, so fall back to a constant
        # (recording stays behavior-neutral either way — this is a read)
        pred = (beliefs.predict(sr) if beliefs.predictor is not None
                else DEFAULT_PRED)
        cands = [candidate_record(v, sr, t, beliefs, pred=pred)
                 for v in self._views(plane, t)]
        propensity, greedy_gid = 1.0, gid
        info = getattr(plane.router, "last_decision_info", None)
        if kind == "route" and info and info.get("rid") == rid:
            propensity = float(info.get("propensity", 1.0))
            greedy_gid = int(info.get("greedy_gid", gid))
        e = {"t": float(t), "rid": rid, "kind": kind, "gid": gid,
             "reason": reason, "propensity": propensity,
             "greedy_gid": greedy_gid,
             "context": {"input_len": int(sr.req.input_len),
                         "pred": float(pred),
                         "slack": float(sr.deadline - t),
                         "slo_class": sr.req.slo_class,
                         "region": sr.req.region,
                         "downstream": int(sr.req.downstream)},
             "candidates": cands,
             "outcome": None}
        self.events.append(e)
        self._by_rid[rid] = e

    def record_outcome(self, sr, t: float, failed: bool):
        """Terminal settlement.  Failures (shed / cascade / lost) record
        a ZERO-reward outcome — dropping them would teach learners that
        doomed arms are merely unobserved."""
        e = self._by_rid.get(int(sr.req.rid))
        if e is None or e["outcome"] is not None:
            return
        met = (not failed) and t <= sr.deadline + 1e-9
        reason = ""
        if failed and sr.journey:
            reason = sr.journey[-1][1]
        e["outcome"] = {"status": "failed" if failed else "done",
                        "t_end": float(t),
                        "latency": float(t - e["t"]),
                        "deadline_met": bool(met),
                        "tokens": int(sr.tokens_out),
                        "reward": 1.0 if met else 0.0,
                        "reason": reason}

    def to_trace(self) -> DecisionTrace:
        return DecisionTrace(requests=self.requests, sim_kw=self.sim_kw,
                             events=self.events, meta=dict(self.meta))


# ---------------------------------------------------------------------------
# What-if replay (full re-simulation under a different policy)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ReplayResult:
    """One what-if re-execution: the rerun's terminal requests plus the
    handles an evaluator probes."""
    requests: list
    duration: float
    sim: object
    plane: object

    def by_rid(self) -> dict:
        return {sr.req.rid: sr for sr in self.requests}


def replay_whatif(trace: DecisionTrace, plane_factory, pool_factory,
                  sim_kw: Optional[dict] = None) -> ReplayResult:
    """Re-execute a logged run under a (possibly different) policy in
    the full simulator: same arrivals, same pool factory, same recorded
    sim knobs — the counterfactual includes every interference effect
    off-policy estimators can only approximate.  ``plane_factory`` takes
    the fresh cluster (a bare router Policy is wrapped); ``sim_kw``
    entries override the recorded knobs."""
    from repro_torch.cluster.simulator import Simulator
    from repro_torch.core.control_plane import ControlPlane
    if not trace.requests:
        raise ValueError("trace records no arrivals: it was recorded on "
                         "a replica plane — merge through the sharded "
                         "gateway's trace property first")
    reqs = trace.requests_objects()
    cluster = pool_factory()
    plane = plane_factory(cluster)
    if not isinstance(plane, ControlPlane):
        plane = ControlPlane(router=plane)
    kw = trace.sim_kwargs()
    kw.update(sim_kw or {})
    sim = Simulator(cluster, plane, reqs, **kw)
    out, dur = sim.run()
    return ReplayResult(requests=out, duration=dur, sim=sim, plane=plane)


def realized_value(result: ReplayResult, trace: DecisionTrace) -> float:
    """Mean per-request goodput reward the replay realized over the
    trace's logged arrivals — the live quantity ``dr_estimate``
    approximates offline."""
    by_rid = result.by_rid()
    rewards = []
    for e in trace.events:
        sr = by_rid.get(e["rid"])
        if sr is None:
            continue
        met = (sr.finished_at is not None
               and sr.finished_at <= sr.deadline + 1e-9)
        rewards.append(1.0 if met else 0.0)
    if not rewards:
        raise ValueError("no logged arrival appears in the replay")
    return float(np.mean(rewards))


def shed_regret(trace: DecisionTrace, result: ReplayResult) -> dict:
    """Shed regret: of the arrivals the logged run shed (admission or
    fairness), how many met their deadline in a what-if replay (typically
    one with admission disabled)?  The fraction feeds
    ``AdmissionController.observe_shed_regret`` — replay-calibrated
    margins instead of hand-tuned ones."""
    by_rid = result.by_rid()
    n_shed = n_would_meet = 0
    for e in trace.events:
        if e["kind"] != "shed":
            continue
        n_shed += 1
        sr = by_rid.get(e["rid"])
        if sr is not None and sr.finished_at is not None \
                and sr.finished_at <= sr.deadline + 1e-9:
            n_would_meet += 1
    return {"n_shed": n_shed, "n_would_meet": n_would_meet,
            "regret": (n_would_meet / n_shed) if n_shed else 0.0}


# ---------------------------------------------------------------------------
# Off-policy evaluation (no re-simulation)
# ---------------------------------------------------------------------------

def dr_estimate(trace: DecisionTrace, policy, max_weight: float = 20.0,
                ) -> dict:
    """Doubly-robust off-policy value of ``policy`` on a logged trace.

    Per routed event with a settled outcome: the direct-model value of
    the arm the candidate picks (per-(hardware, load-bucket) mean logged
    reward, global fallback), plus — when the candidate agrees with the
    logged action — the importance-weighted residual
    ``(reward - Q̂(logged arm)) / propensity`` (weights clipped at
    ``max_weight``).  Unbiased when either the direct model or the
    logged propensities are right; the variance stays bounded because
    disagreeing events contribute the model term only.

    ``policy`` needs one method: ``offline_choose(event) -> iid`` over
    the trace's frozen candidate features.
    """
    events = [e for e in trace.route_events() if e["candidates"]]
    if not events:
        raise ValueError("trace holds no routed events with outcomes")

    by_key: Dict[tuple, list] = {}
    rewards = []
    for e in events:
        r = float(e["outcome"]["reward"])
        rewards.append(r)
        c = _cand(e, e["gid"])
        if c is not None:
            by_key.setdefault((c["hw"], c["bucket"]), []).append(r)
    global_mean = float(np.mean(rewards))
    qtab = {k: float(np.mean(v)) for k, v in by_key.items()}

    def qhat(c) -> float:
        if c is None:
            return global_mean
        return qtab.get((c["hw"], c["bucket"]), global_mean)

    vals, direct, matches = [], [], 0
    for e in events:
        gid = policy.offline_choose(e)
        v = qhat(_cand(e, gid))
        direct.append(v)
        if gid == e["gid"]:
            matches += 1
            w = min(1.0 / max(float(e["propensity"]), 1e-6), max_weight)
            v += w * (float(e["outcome"]["reward"]) - qhat(_cand(e, gid)))
        vals.append(v)
    return {"value": float(np.mean(vals)),
            "direct": float(np.mean(direct)),
            "behavior_value": global_mean,
            "match_rate": matches / len(events),
            "n": len(events)}


def _cand(event: dict, gid) -> Optional[dict]:
    for c in event["candidates"]:
        if c["iid"] == gid:
            return c
    return None


class JustEnoughOfflinePolicy:
    """Offline surrogate of the just-enough heuristic, scoring purely
    from a trace event's frozen features (so the DR estimator can put a
    heuristic arm on the same footing as the learned ones): feasible =
    wait + prefill + decode within ``margin`` x slack; among feasible
    take the slowest decode (just-enough), otherwise the minimum
    predicted total."""

    _W = FEATURE_NAMES.index("wait_s")
    _P = FEATURE_NAMES.index("prefill_s")
    _D = FEATURE_NAMES.index("decode_s")

    def __init__(self, margin: float = 0.7):
        self.margin = margin

    def offline_choose(self, event: dict) -> int:
        cands = event.get("candidates") or []
        if not cands:
            return -1
        slack = float(event["context"]["slack"])
        total = [c["x"][self._W] + c["x"][self._P] + c["x"][self._D]
                 for c in cands]
        feasible = [(c, tot) for c, tot in zip(cands, total)
                    if tot <= self.margin * slack]
        if feasible:
            return max(feasible,
                       key=lambda ct: (ct[0]["x"][self._D],
                                       -ct[0]["iid"]))[0]["iid"]
        return min(zip(cands, total),
                   key=lambda ct: (ct[1], ct[0]["iid"]))[0]["iid"]
