"""Request routers: GoodServe (Alg. 1) + the paper's baselines (Sec. 2.2).

Copy of ``repro/core/router.py`` (numpy and plain Python),
kept in the port so that it imports nothing of ``repro``.  Its imports
and references name ``repro_torch`` where the reference names
``repro``; any other line that differs carries a comment saying so.
Everything else, float expressions and iteration orders included, is
as written there.

All routers see the same black-box cluster observables, and they see
them ONLY through the :class:`~repro_torch.core.observability.ClusterView`
snapshot API — no router walks an Instance's internal queues or batch
lists directly (enforced by tests/test_observability.py).
GoodServe additionally consults the plane's shared
:class:`~repro_torch.core.control_plane.Beliefs` (predictor + rectifier +
eviction-rate posterior) and the EMA estimates carried on the views,
makes the *just-enough* selection (slowest feasible instance), and
yields rescue ``Migrate`` decisions for SLO-at-risk requests at
runtime.  The Oracle router gets ground-truth lengths and the analytic
hardware model — the upper bound of Fig. 2.

Routers are :class:`~repro_torch.core.control_plane.Policy` objects hosted by
a ControlPlane: they actuate only through yielded Decision values; the
simulator executes.
"""
from __future__ import annotations

import time
from collections import deque
from typing import List

import numpy as np

from repro_torch.cluster import hardware as hwlib
from repro_torch.cluster.simulator import SimRequest
from repro_torch.core import control_plane as cplib
from repro_torch.core import migration as miglib
from repro_torch.core import rectify as rectlib
from repro_torch.core.control_plane import Beliefs, Migrate, Route, predict_output
from repro_torch.core.observability import ClusterView, InstanceView

__all__ = ["Router", "GoodServeRouter", "OracleRouter", "make_router",
           "ALL_BASELINES", "predict_output"]


class Router(cplib.Policy):
    name = "base"

    def __init__(self, seed: int = 0):
        super().__init__()
        self.rng = np.random.default_rng(seed)
        self.decision_times: List[float] = []

    @property
    def sim(self):
        """The simulator behind the plane (tests and examples poke it;
        policy code itself must stay on the view API)."""
        return self.plane.sim if self.plane is not None else None

    @property
    def cluster(self):
        return self.plane.cluster

    def view(self, t: float) -> ClusterView:
        """Fresh proxy-visible snapshot of the whole pool."""
        return self.plane.view(t)

    def targets(self, t: float) -> List[InstanceView]:
        """Instances currently accepting admissions, in iid order.  When
        admission is closed everywhere (e.g. the last active instance
        just failed while others drain, or every spot instance is in an
        overlapping eviction-grace window), fall back to alive
        draining/evicting instances — stranding work on an empty target
        list would crash failure resubmission, and an evicting instance
        still serves for its grace window (its stragglers are
        resubmitted at the kill).  In role-split pools, fresh work goes
        to prefill-capable instances (role "prefill"/"both") when any
        accept — decode specialists only take queue-less handoffs — but
        a decode-only remainder still beats stranding the request."""
        cv = self.view(t)
        views = cv.accepting()
        if views:
            pf = [v for v in views if v.can_prefill]
            return pf or views
        drain = [v for v in cv.instances
                 if v.alive and v.state == "draining"]
        if drain:
            return drain
        return [v for v in cv.instances
                if v.alive and v.state == "evicting"]

    def decode_targets(self, t: float,
                       exclude: int = -1) -> List[InstanceView]:
        """Accepting decode-capable instances (role "decode"/"both"),
        minus ``exclude`` — the eligible handoff destinations."""
        cv = self.view(t)
        return [v for v in cv.decode_capable() if v.iid != exclude]

    # -- interface ----------------------------------------------------------

    def route(self, sr: SimRequest, t: float) -> int:
        t0 = time.perf_counter()
        gid = self._route(sr, t)
        self.decision_times.append(time.perf_counter() - t0)
        return gid

    def _route(self, sr: SimRequest, t: float) -> int:
        raise NotImplementedError

    def on_failure(self, gid: int, victims, t: float):
        """Token-ID resubmission of a dead instance's requests: one
        ``Route`` per victim, executed as yielded — so each routing
        decision sees the previous victim already enqueued."""
        for sr in victims:
            yield Route(self.route(sr, t), sr=sr)

    def on_prefill_done(self, sr: SimRequest, t: float):
        """Default disaggregation hand-off, deliberately
        region-OBLIVIOUS: least-pending decode-capable target, transfer
        mode per the crossover model on whatever link that pair
        resolves to.  This is the naive router fig19 measures against —
        it happily ships KV across the WAN.  Yields nothing (decode
        colocated) only when no decode target exists."""
        views = self.decode_targets(t, exclude=sr.instance)
        if not views:
            return
        v = min(views, key=lambda w: (w.pending, w.iid))
        net = self.plane.link(sr.instance, v.iid)
        mode = miglib.plan_handoff(net, v.hw, v.fp, sr.context_len,
                                   prefix_hit=v.prefix_hit(sr.req))
        yield cplib.Handoff(sr=sr, dst=v.iid, mode=mode)


# ---------------------------------------------------------------------------
# Baselines
# ---------------------------------------------------------------------------

class RandomP2C(Router):
    """Power-of-two-choices random routing [Ray Serve default]."""
    name = "random"

    def _route(self, sr, t):
        views = self.targets(t)
        a, b = self.rng.choice(len(views), size=2, replace=len(views) < 2)
        va, vb = views[int(a)], views[int(b)]
        return va.iid if va.pending <= vb.pending else vb.iid


class RoundRobin(Router):
    name = "round_robin"

    def __init__(self, seed: int = 0):
        super().__init__(seed)
        self._next = 0   # instance state: two routers must not interfere

    def _route(self, sr, t):
        views = self.targets(t)
        gid = views[self._next % len(views)].iid
        self._next += 1
        return gid


class LeastRequest(Router):
    """AIBrix least-request: fewest pending requests."""
    name = "least_request"

    def _route(self, sr, t):
        return min(self.targets(t), key=lambda v: v.pending).iid


class LowestTPM(Router):
    """LiteLLM lowest tokens-per-minute utilization."""
    name = "lowest_tpm"

    def _route(self, sr, t):
        return min(self.targets(t), key=lambda v: v.tpm).iid


class PrefixCacheRouter(Router):
    """AIBrix prefix-cache: max prefix hit, ties by least pending."""
    name = "prefix_cache"

    def _route(self, sr, t):
        return min(self.targets(t),
                   key=lambda v: (-v.prefix_hit(sr.req), v.pending)).iid


class PrebleRouter(Router):
    """Preble-style joint prefix + load scoring [arXiv:2407.00023]:
    cost = (1 - hit fraction) * input_len (prefill work) + queued work."""
    name = "preble"

    def _route(self, sr, t):
        best, best_score = None, float("inf")
        for v in self.targets(t):
            hit = v.prefix_hit(sr.req)
            prefill_work = (sr.req.input_len - hit)
            queued_work = sum(v.queued_prefill_tokens) + 64 * v.n_running
            score = prefill_work + queued_work
            if score < best_score:
                best, best_score = v.iid, score
        return best


class LlumnixRouter(Router):
    """Llumnix-style [OSDI'24]: route to max free memory; periodic
    load-balancing via (KV) migration between most/least loaded."""
    name = "llumnix"
    imbalance_threshold = 4

    def _route(self, sr, t):
        return min(self.targets(t), key=lambda v: v.mem_used_frac).iid

    def on_tick(self, t):
        views = self.targets(t)
        if len(views) < 2:
            return
        views = sorted(views, key=lambda v: v.pending)
        lo, hi = views[0], views[-1]
        if hi.pending - lo.pending >= self.imbalance_threshold:
            sr = hi.newest_queued()
            if sr is not None:
                yield Migrate(sr, lo.iid, "token_id")
                return
            sr = hi.longest_running()
            if sr is not None:
                yield Migrate(sr, lo.iid, "kv")


# ---------------------------------------------------------------------------
# GoodServe (Algorithm 1) + Oracle
# ---------------------------------------------------------------------------

class GoodServeRouter(Router):
    """Predict-and-rectify goodput routing (paper Sec. 3.4, Alg. 1),
    extended to multi-step agentic workflows: for a DAG step the router
    predicts the *remaining workflow work* (downstream critical-path
    steps x predictor-sized per-step decode), checks feasibility against
    the single per-workflow deadline (budgeting slack across the
    remaining steps), and prefers the instance holding the session's
    cached KV prefix among feasible candidates.  Risk checks and
    migration likewise operate on workflow slack, not per-step slack."""
    name = "goodserve"

    def __init__(self, predictor=None, seed: int = 0,
                 enable_migration: bool = True,
                 migration_mode: str = "token_id", margin: float = 0.7,
                 spot_aware: bool = True, rectifier=None, evict_rates=None,
                 beliefs: Beliefs = None, class_slack=None):
        super().__init__(seed)
        # SLO-class-aware slack: the effective slack each class budgets
        # against is scaled per class — interactive (< 1) routes
        # conservatively, best-effort (> 1) may ride slower or queued
        # capacity.  Unclassed requests ("") fall through to 1.0, so a
        # class-free workload routes byte-identically to the class-blind
        # router (x1.0 is a float identity).
        self.class_slack = dict({"interactive": 0.85, "best_effort": 1.25}
                                if class_slack is None else class_slack)
        # estimation state lives in ONE Beliefs bundle — pass a shared
        # instance (new style: the same object the plane and the
        # admission path hold) or the legacy predictor/rectifier/
        # evict_rates pieces and a private bundle is built:
        #   * predictor — admission-time output-length model,
        #   * rectifier (core/rectify.py OnlineSurvival) — turns stale
        #     point predictions into conditional remaining-length
        #     estimates as tokens stream; None reproduces the static
        #     admission-time point estimate,
        #   * evict_rates — rate provider for the spot surcharge.  The
        #     catalog's rate field is the simulator's ground truth, not
        #     an observable — by default a Gamma-Poisson posterior
        #     learned from visible notices; rectlib.FixedEvictionRates
        #     is the oracle-rate ablation.
        if beliefs is not None:
            if predictor is not None or rectifier is not None \
                    or evict_rates is not None:
                raise TypeError("pass beliefs OR the individual "
                                "predictor/rectifier/evict_rates pieces")
            # the shared bundle is the caller's: never mutate it.  A
            # bundle without evict_rates simply prices no spot risk.
            self.beliefs = beliefs
        else:
            if evict_rates is None and spot_aware:
                # a spot-oblivious router never reads the estimate —
                # installing a default estimator would only buy a
                # per-tick snapshot + posterior update for nothing
                evict_rates = rectlib.EvictionRateEstimator()
            self.beliefs = Beliefs(predictor=predictor,
                                   rectifier=rectifier,
                                   evict_rates=evict_rates)
        self.enable_migration = enable_migration
        self.migration_mode = migration_mode
        # charge preemptible instances an eviction-risk surcharge in the
        # FEASIBILITY test (spot_aware=False is the spot-oblivious
        # ablation: identical policy, risk term zeroed)
        self.spot_aware = spot_aware
        self._rr_cold = 0   # instance state: cold-start round-robin cursor
        # feasibility margin: T <= margin * slack.  The EMA estimates lag a
        # growing batch and exclude this request's own interference, so
        # riding the exact T == D_r boundary tips marginal requests over;
        # beta < 1 absorbs that noise (rectified further by migration).
        self.margin = margin
        # in-flight accounting: (t, gid, expected prefill seconds) of
        # requests routed recently — work the proxy KNOWS is coming but the
        # EMAs haven't observed yet.  Kills the cold-herd where a burst all
        # sees the same stale "feasible" slow instance.
        self._recent_routes: list = []
        self.inflight_window_s = 3.0
        # per-instance completion timestamps (proxy-visible: the proxy
        # streams every response).  Queues on a slot-saturated engine
        # drain at the COMPLETION rate, not the prefill rate — without
        # this term the wait estimate collapses at overload and the
        # fallback path herds every request onto the fastest instance.
        self._completions: dict = {}
        self.completion_window_s = 45.0

    # read-only views onto the shared bundle (legacy attribute names)
    @property
    def predictor(self):
        return self.beliefs.predictor

    @property
    def rectifier(self):
        return self.beliefs.rectifier

    @property
    def evict_rates(self):
        return self.beliefs.evict_rates

    def _predict(self, sr: SimRequest) -> float:
        # conditional rectification (Beliefs.predict): a request that
        # has streamed past its point prediction gets E[L | L >
        # generated] off the empirical survival curve, not a "one more
        # token" clamp
        return self.beliefs.predict(sr)

    @staticmethod
    def _downstream_steps(sr: SimRequest) -> int:
        """Steps left on the workflow's longest remaining chain after this
        one — DAG *structure* is client-declared and router-visible;
        step lengths are not (the predictor sizes them)."""
        return max(sr.req.downstream, 0)

    def _downstream_unit(self, sr: SimRequest) -> float:
        """Per-step decode size for the DOWNSTREAM slack budget: the
        UNCONDITIONAL rectified estimate (Beliefs.step_estimate).  The
        current step's conditional total inflates once its own
        prediction is falsified — evidence about this step, not about
        its children, so budgeting children with it overstates the
        remaining critical path."""
        return self.beliefs.step_estimate(sr)

    def _prune_recent(self, t: float):
        """Drop in-flight entries older than the window — ONCE per
        routing decision (not once per candidate instance)."""
        self._recent_routes = [r for r in self._recent_routes
                               if t - r[0] < self.inflight_window_s]

    def _inflight(self, i: int) -> float:
        return sum(w for (t0, gid, w) in self._recent_routes if gid == i)

    def _completion_rate(self, v: InstanceView, t: float) -> float:
        """Requests/s the instance finishes, over a recent window; 0.0
        when there isn't enough signal yet."""
        dq = self._completions.get(v.iid)
        if not dq:
            return 0.0
        while dq and t - dq[0] > self.completion_window_s:
            dq.popleft()
        if len(dq) < 2:
            return 0.0
        return len(dq) / max(t - dq[0], 1e-3)

    def _slot_wait(self, v: InstanceView, t: float) -> float:
        """Expected wait for the queue ahead to clear at the instance's
        observed completion rate (dominates when the engine is at its
        admission cap and the queue drains one slot per finish)."""
        if v.n_queued == 0:
            return 0.0
        rate = self._completion_rate(v, t)
        if rate <= 0.0:
            return 0.0
        return v.n_queued / rate

    def _queue_uncertainty(self, v: InstanceView, t: float) -> float:
        """One completion interval of slack the estimates cannot see on
        a queued instance (queue-wait predictions err by about one
        drain step).  Charged against the FEASIBILITY test only: a
        tight request shouldn't bet its deadline on a queued instance
        when an unqueued one is feasible too, but overload ranking (the
        fallback) must stay unpenalized or everything herds."""
        if v.n_queued == 0:
            return 0.0
        rate = self._completion_rate(v, t)
        return 1.0 / rate if rate > 0.0 else 0.0

    def _queue_estimate(self, v: InstanceView, t: float) -> float:
        """AVGWAITTIME(g) as a *live* signal: combine the EMA of completed
        waits with the current queue's in-progress waits, its expected
        drain (queued prefill work x EMA prefill rate), and the unobserved
        prefill work of just-routed requests — all proxy-side observable,
        so still black-box w.r.t. the engine."""
        inflight = self._inflight(v.iid)
        if v.n_queued == 0:
            return v.ema.q + inflight
        live = float(np.mean(v.queued_ages))
        drain = v.ema.p * sum(v.queued_prefill_tokens)
        return max(v.ema.q, live + drain, self._slot_wait(v, t)) + inflight

    def _eviction_risk(self, v: InstanceView, horizon: float,
                       context_len: float) -> float:
        """Expected latency surcharge for parking a request on
        preemptible capacity: P(eviction notice lands during the
        request's ~``horizon`` residence) x the recovery detour (escape
        transfer, renewed queueing, and a likely re-prefill of the
        context elsewhere).  Charged against the FEASIBILITY test only —
        like ``_queue_uncertainty`` — so tight-slack requests keep off
        spot while the best-effort fallback ranking stays unpenalized
        and long-tail work soaks up the discounted capacity.  The rate
        comes from ``self.evict_rates`` — by default the Gamma-Poisson
        posterior learned from observed notices, never the oracle field
        on the hardware spec (source-scan enforced)."""
        if not self.spot_aware or not v.is_spot \
                or self.evict_rates is None:
            return 0.0
        rate = self.evict_rates.rate_per_hour(v.hw.name) / 3600.0
        if rate <= 0.0:
            return 0.0
        p_evict = 1.0 - float(np.exp(-rate * max(horizon, 0.0)))
        recovery = (miglib.FIXED_OVERHEAD_S + v.ema.q
                    + v.ema.p * max(context_len, 0.0))
        return p_evict * recovery

    def _hop_costs(self, sr: SimRequest, views, t: float):
        """Expected prefill→decode handoff latency if this arrival is
        admitted on each candidate — nonzero only for prefill-role
        candidates (zero everywhere in flat pools, keeping legacy
        replay byte-identical).  GoodServe budgets the region hop at
        admission the way it budgets downstream workflow steps: the
        cost is deducted from slack in the feasibility test, so a
        tight request avoids a prefill instance whose only decode
        escape crosses the WAN."""
        hop = np.zeros(len(views))
        if not any(v.role == "prefill" for v in views):
            return hop
        dec = self.decode_targets(t)
        ctx = sr.req.input_len
        for i, v in enumerate(views):
            if v.role != "prefill":
                continue
            costs = []
            for w in dec:
                if w.iid == v.iid:
                    continue
                net = self.plane.link(v.iid, w.iid)
                mode = miglib.plan_handoff(net, w.hw, w.fp, ctx)
                costs.append(miglib.handoff_latency(net, w.hw, w.fp,
                                                    ctx, mode))
            if costs:
                hop[i] = min(costs)
        return hop

    def _latencies(self, sr: SimRequest, views, remaining_out: float,
                   context_len: int, t: float):
        """Vectorized T(r,g) over candidate instance views (Eq. 2)."""
        q = np.array([self._queue_estimate(v, t) for v in views])
        p = np.array([v.ema.p for v in views])
        d = np.array([v.ema.d for v in views])
        hits = np.array([v.prefix_hit(sr.req) for v in views], np.float32)
        T = q + p * np.maximum(context_len - hits, 0) + d * remaining_out
        return T, d

    def _current_d(self, v: InstanceView, sr: SimRequest) -> float:
        return v.ema.d

    max_migrations = 2
    min_obs = 3          # cold-start: explore before trusting EMAs
    tie_eps = 0.15       # d-equivalence band for the just-enough tie-break

    def _route(self, sr, t):
        sr.pred_out = self._predict(sr)
        if sr.pred_admit == 0.0:      # keep the first-admission belief
            sr.pred_admit = sr.pred_out
        views = self.targets(t)
        self._prune_recent(t)
        cold = [v.iid for v in views if v.ema.n_obs < self.min_obs]
        if cold:
            self._rr_cold += 1
            return cold[self._rr_cold % len(cold)]
        T, d = self._latencies(sr, views, sr.pred_out, sr.req.input_len, t)
        slack = (sr.deadline - t) * self.class_slack.get(sr.req.slo_class,
                                                         1.0)
        # remaining workflow work after this step: assume downstream steps
        # are predictor-sized decodes (their prefills mostly hit the
        # session cache under affinity routing); each is sized by the
        # UNCONDITIONAL rectified estimate, not this step's mid-flight
        # belief
        down = self._downstream_steps(sr)
        R = T + down * d * (self._downstream_unit(sr) if down else 0.0)
        unc = np.array([self._queue_uncertainty(v, t) for v in views])
        ctx = sr.req.input_len + sr.pred_out
        risk = np.array([self._eviction_risk(v, float(T[i]), ctx)
                         for i, v in enumerate(views)])
        hop = self._hop_costs(sr, views, t)
        feasible = np.nonzero(R + hop + unc + risk
                              <= self.margin * slack)[0]
        if feasible.size:                       # just-enough: slowest feasible
            if sr.req.session >= 0:
                # prefer the instance holding the session's cached prefix
                hits = np.array([views[int(i)].session_hit(sr.req)
                                 for i in feasible])
                if (hits > 0).any():
                    feasible = feasible[hits > 0]
            if sr.req.region:
                # regional arrival mix: among feasible candidates,
                # prefer the request's origin region — keeps the later
                # prefill→decode hop (and any rescue) intra-region
                same = np.array([views[int(i)].region == sr.req.region
                                 for i in feasible])
                if same.any():
                    feasible = feasible[same]
            # just-enough across SPEED CLASSES, load-balanced within one:
            # concentrating on the single max-d instance preserves fast
            # GPUs in a heterogeneous pool, but in a pool of near-equal
            # instances it only builds a convoy — so among instances
            # within tie_eps of the slowest feasible speed, take the one
            # with the lowest estimated latency
            dmax = float(d[feasible].max())
            near = feasible[d[feasible] >= (1 - self.tie_eps) * dmax]
            k = near[np.argmin(T[near])]
        else:
            # best-effort fallback: minimum predicted violation, but
            # load-balanced within the near-minimum class — a lagging
            # queue estimate otherwise funnels a whole burst of
            # infeasible requests into one convoy on the fastest GPU
            near = np.nonzero(R <= R.min() + 0.25 * max(slack, 0.5))[0]
            pend = np.array([views[int(i)].pending for i in near])
            k = near[int(np.argmin(pend))]
        chosen = views[int(k)]
        work = chosen.ema.p * sr.req.input_len \
            + 0.1 * chosen.ema.d * sr.pred_out
        self._recent_routes.append((t, chosen.iid, work))
        return chosen.iid

    def on_step_done(self, sr: SimRequest, t: float):
        """Periodic SLO-risk checkpoint (every tau decode iterations):
        rectify the remaining-length belief and, when the current
        instance can no longer make the (workflow) deadline, yield one
        rescue ``Migrate`` to a stronger feasible target."""
        if (not self.enable_migration or sr.state != "running"
                or sr.n_migrations >= self.max_migrations):
            return
        # rectify: re-predict remaining length, re-read instance status
        total_pred = max(self._predict(sr), sr.tokens_out + 1.0)
        remaining = total_pred - sr.tokens_out
        sr.pred_out = total_pred
        gid = sr.instance
        cv = self.view(t)
        self._prune_recent(t)
        down = self._downstream_steps(sr)
        unit = self._downstream_unit(sr) if down else 0.0
        d_here = self._current_d(cv.view(gid), sr)
        # workflow slack: this step's remaining decode plus the estimated
        # downstream steps must all fit before the workflow deadline
        finish_here = d_here * (remaining + down * unit)
        slack = (sr.deadline - t) * self.class_slack.get(sr.req.slo_class,
                                                         1.0)
        if finish_here <= slack:
            return
        # current instance will violate: find a stronger feasible target,
        # still just-enough among feasible (Sec. 3.4)
        views = [v for v in cv.accepting() if v.iid != gid]
        if not views:
            return
        T, d = self._latencies(sr, views, remaining, sr.context_len, t)
        R = T + down * d * unit
        # same eviction-risk surcharge as the admission path: a rescue
        # that parks a tight request on spot just trades one miss cause
        # for another
        risk = np.array([self._eviction_risk(
            v, float(T[i]), sr.context_len + remaining)
            for i, v in enumerate(views)])
        feasible = np.nonzero(R + risk <= self.margin * slack)[0]
        if feasible.size:
            k = int(feasible[np.argmax(d[feasible])])
        else:
            k = int(np.argmin(R))
            # only move if materially better than staying (avoid ping-pong)
            if R[k] >= 0.8 * finish_here:
                return
        yield Migrate(sr, views[k].iid, self.migration_mode)

    def on_prefill_done(self, sr: SimRequest, t: float):
        """Region- and role-aware decode placement (the disaggregation
        chain's second link).  For every decode-capable target, price
        the hop on the network tier this pair resolves to (crossover
        picks KV vs token-ID per tier), deduct it from the remaining
        slack exactly like a downstream workflow step, and drop targets
        that cannot clear the deadline.  Among the survivors prefer
        same-region (the WAN tier only wins when nothing nearby is
        feasible), then earliest finish.  When NO handoff clears the
        deadline, yield nothing: the request decodes where it prefilled
        — slower silicon for decode is better than a missed SLO."""
        cv = self.view(t)
        views = [v for v in cv.decode_capable() if v.iid != sr.instance]
        if not views:
            return
        total_pred = max(self._predict(sr), sr.tokens_out + 1.0)
        remaining = total_pred - sr.tokens_out
        sr.pred_out = total_pred
        slack = (sr.deadline - t) * self.class_slack.get(sr.req.slo_class,
                                                         1.0)
        down = self._downstream_steps(sr)
        unit = self._downstream_unit(sr) if down else 0.0
        here = cv.view(sr.instance)
        self._prune_recent(t)
        best = None
        for v in views:
            net = self.plane.link(sr.instance, v.iid)
            hit = v.prefix_hit(sr.req)
            mode = miglib.plan_handoff(net, v.hw, v.fp, sr.context_len,
                                       prefix_hit=hit)
            R = (miglib.handoff_latency(net, v.hw, v.fp, sr.context_len,
                                        mode, prefix_hit=hit)
                 + self._queue_estimate(v, t)
                 + v.ema.d * (remaining + down * unit))
            risk = self._eviction_risk(v, R, sr.context_len + remaining)
            if R + risk > self.margin * slack:
                continue
            key = (0 if v.region == here.region else 1, R, v.iid)
            if best is None or key < best[0]:
                best = (key, v, mode)
        if best is None:
            return
        _, v, mode = best
        yield cplib.Handoff(sr=sr, dst=v.iid, mode=mode)

    def on_request_done(self, sr: SimRequest, t: float):
        # per-instance completion-rate window (the slot-wait signal).
        # Survival-curve and online-predictor feedback is NOT fed here:
        # the plane fans completions out to the shared Beliefs exactly
        # once, no matter how many policies hold the bundle.
        if sr.instance is not None:
            dq = self._completions.setdefault(sr.instance, deque())
            dq.append(t)
            while dq and t - dq[0] > self.completion_window_s:
                dq.popleft()     # bound growth while the queue stays empty


class OracleRouter(GoodServeRouter):
    """Ground-truth lengths + analytic hardware rates, same just-enough
    policy (the Fig. 2 oracle).

    Even ground truth is myopic about *future arrivals*: a request admitted
    exactly at the feasibility edge is pushed over it by the batch
    interference of requests routed afterwards.  The margin reserves
    headroom for that — it models future load, not estimation error."""
    name = "oracle"

    def __init__(self, seed: int = 0, enable_migration: bool = True,
                 margin: float = 0.7, evict_rates=None):
        # predictor=None: the oracle reads ground-truth lengths instead
        # (so it never rectifies — there is nothing to rectify)
        super().__init__(None, seed=seed, enable_migration=enable_migration,
                         migration_mode="token_id", margin=margin,
                         evict_rates=evict_rates)

    def _predict(self, sr):
        return float(sr.req.output_len)

    def _downstream_unit(self, sr):
        # ground truth sizes downstream steps too (nothing to rectify)
        return float(sr.req.output_len)

    def _latencies(self, sr, views, remaining_out, context_len, t):
        T, d = [], []
        for v in views:
            b = max(v.n_running, 1)
            avg_ctx = (float(np.mean(v.running_context_lens))
                       if v.running_context_lens else context_len)
            d_i = hwlib.decode_iteration_time(v.hw, v.fp, b + 1, avg_ctx)
            hit = v.prefix_hit(sr.req)
            q_i = sum(hwlib.prefill_time(v.hw, v.fp, pl)
                      for pl in v.queued_prefill_tokens)
            q_i += self._inflight(v.iid)
            p_full = hwlib.prefill_time(v.hw, v.fp, context_len, hit)
            T.append(q_i + p_full + d_i * remaining_out)
            d.append(d_i)
        return np.asarray(T), np.asarray(d)

    def _current_d(self, v, sr):
        b = max(v.n_running, 1)
        avg_ctx = (float(np.mean(v.running_context_lens))
                   if v.running_context_lens else sr.context_len)
        return hwlib.decode_iteration_time(v.hw, v.fp, b, avg_ctx)


ALL_BASELINES = [RandomP2C, RoundRobin, LeastRequest, LowestTPM,
                 PrefixCacheRouter, PrebleRouter, LlumnixRouter]


def make_router(name: str, predictor=None, **kw) -> Router:
    table = {c.name: c for c in ALL_BASELINES}
    if name in table:
        return table[name](**kw)
    if name == "goodserve":
        beliefs = kw.get("beliefs")
        assert predictor is not None or (
            beliefs is not None and beliefs.predictor is not None)
        return GoodServeRouter(predictor, **kw)
    if name == "oracle":
        return OracleRouter(**kw)
    if name == "bandit":
        # lazy: learned_router imports Router from this module
        # (predictor-less planes fall back to replay.DEFAULT_PRED)
        from repro_torch.core.learned_router import BanditRouter
        return BanditRouter(predictor, **kw)
    raise KeyError(name)
