"""Elastic pool-scaling + admission policies for the control plane.

Copy of ``repro/core/controller.py`` (numpy and plain Python),
kept in the port so that it imports nothing of ``repro``.  Its imports
and references name ``repro_torch`` where the reference names
``repro``; any other line that differs carries a comment saying so.
Everything else, float expressions and iteration orders included, is
as written there.

The paper serves a *fixed* heterogeneous pool; operators don't.  This
module adds the policies that close the loop over the
:class:`~repro_torch.core.observability.ClusterView` snapshot API (they never
touch ``Instance`` internals — enforced by tests/test_torch_observability.py):

* :class:`ReactivePoolController` — scales the pool against *observed*
  queue pressure: provision the most cost-effective catalog type when
  pending-per-instance crosses the high watermark, drain the worst
  goodput-per-dollar instance after sustained slack (SageServe-style
  reactive tier, arXiv:2502.14617).
* :class:`ForecastPoolController` — same actuators, but decides on the
  pressure *predicted* at ``now + warmup``: a Holt linear-trend forecast
  of the arrival rate, minus the observed completion rate, projects
  queue growth so capacity is provisioned BEFORE the diurnal swell hits
  (hiding warmup latency) and drained as demand falls off.
* :class:`AdmissionController` — AccelGen-style SLO-aware admission
  (arXiv:2503.13737): a request whose *most optimistic* predicted
  critical path (fastest accepting instance, remaining downstream steps
  included) already exceeds its deadline slack is shed on arrival.
  Early-shed beats late-miss: the doomed work would burn capacity that
  feasible requests need, and a shed cascades to the workflow's
  now-unmeetable descendants.

All three are :class:`~repro_torch.core.control_plane.Policy` objects hosted
by a ControlPlane: they observe through ``plane.view(t)``, and they
actuate ONLY by yielding :class:`~repro_torch.core.control_plane.Decision`
values (``Provision`` / ``Drain``) that the simulator executes — the
actuation result (new instance id, drain acceptance) comes back through
the ``yield``.

Controllers are operator-side: they may read the hardware catalog
(that's what the operator pays for) but only proxy-visible signals from
the serving side.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from repro_torch.cluster import hardware as hwlib
from repro_torch.core import control_plane as cplib
from repro_torch.core.control_plane import Beliefs, Drain, Provision


class PoolController(cplib.Policy):
    """Base: a no-op controller (the static-pool mode)."""
    name = "static"

    def __init__(self):
        super().__init__()
        self.events: List[Tuple[float, str, str]] = []  # (t, action, detail)

    def _log(self, t: float, action: str, detail: str):
        self.events.append((t, action, detail))


class ReactivePoolController(PoolController):
    """Queue-pressure autoscaling over the heterogeneous catalog.

    Two separate signals, both per-instance and counting warming capacity
    against scale-up (already paid for, arriving soon — no provisioning
    stampede):

    * scale-UP on queue-weighted load (running + 3 x queued): deep
      decode batches are the leading indicator of demand approaching
      capacity, and queued requests (engines at their admission cap)
      escalate it.  Queue depth ALONE is a trap: a smarter router
      suppresses queueing, which would starve the very signal that buys
      it capacity — running load is conserved across routing policies;
    * scale-DOWN on total pending (queue + running): only when the pool
      is genuinely idle, after ``cooldown`` consecutive low looks.

    Scale-up picks the catalog type with the best decode bandwidth per
    dollar (decode is memory-bound).  Scale-down drains the worst
    measured speed-per-dollar instance (EMA TPOT x $/hr) among the
    instances THIS controller provisioned — the operator's reserved base
    pool is never drained (``protect_base``)."""
    name = "reactive"

    def __init__(self, scale_types: Sequence = ("A800", "A40"),
                 max_instances: int = 8, min_active: int = 1,
                 interval: float = 5.0, hi_load: float = 12.0,
                 lo_pending: float = 1.5, cooldown: int = 4,
                 protect_base: bool = True,
                 warmup_override: Optional[float] = None,
                 max_warming: int = 1,
                 spot_types: Sequence = (), max_spot: int = 4,
                 replace_evicted: bool = True):
        super().__init__()
        self.scale_types = tuple(scale_types)
        # spot-aware elasticity: scale-up prefers preemptible capacity
        # (it's the cheap marginal unit — the paper's goodput-per-$ is
        # won at the margin) up to ``max_spot`` concurrently, keeping the
        # on-demand base pool as the protected floor; an eviction notice
        # triggers an immediate replacement provision so the new
        # instance's warmup hides inside the dying one's grace window.
        self.spot_types = tuple(spot_types)
        self.max_spot = max_spot
        self.replace_evicted = replace_evicted
        self.max_instances = max_instances
        self.min_active = min_active
        self.interval = interval
        self.hi_load = hi_load
        self.lo_pending = lo_pending
        self.cooldown = cooldown
        self.protect_base = protect_base
        self.warmup_override = warmup_override
        # anti-stampede: the backlog a warming instance will absorb is
        # still visible as queue depth, so without this cap every look
        # during warmup buys yet another instance
        self.max_warming = max_warming
        self._owned: set = set()      # iids this controller provisioned
        # first look lands one interval in, so the forecaster's first
        # rate sample spans a real window (not a clamped huge one)
        self._last_look = 0.0
        self._lo_streak = 0

    # -- policy pieces ------------------------------------------------------

    min_bw_frac = 0.5   # don't buy types <50% of the pool's fastest: too
                        # slow to meet the SLOs the fast tier was sized for

    @staticmethod
    def _resolve(types) -> List[hwlib.HardwareSpec]:
        """Entries are catalog names OR full HardwareSpecs — the latter
        lets the operator provision the same engine config (max_seqs
        etc.) as the base pool, not the stock catalog entry."""
        return [hwlib.catalog(n) if isinstance(n, str) else n
                for n in types]

    def _catalog(self) -> List[hwlib.HardwareSpec]:
        return self._resolve(self.scale_types)

    def _pick(self, cands, view) -> hwlib.HardwareSpec:
        """Most cost-effective capacity: decode bandwidth per dollar,
        among catalog types fast enough relative to the current pool
        (a dirt-cheap GPU that can't hit the SLO is negative goodput:
        every request routed there is a likely miss)."""
        if view is not None and view.active():
            fastest = max(v.hw.eff_bw for v in view.active())
            fast_enough = [hw for hw in cands
                           if hw.eff_bw >= self.min_bw_frac * fastest]
            cands = fast_enough or cands
        return max(cands, key=lambda hw: hw.eff_bw / hw.cost_per_hour)

    def _n_spot(self, view) -> int:
        """Preemptible instances up or on the way (active + warming)."""
        if view is None:
            return 0
        return sum(1 for v in view.active() + view.warming() if v.is_spot)

    def pick_scale_up(self, view=None) -> hwlib.HardwareSpec:
        """Prefer spot capacity at the margin (deep discount dominates
        bandwidth/$) while the concurrent-spot cap leaves room; the
        on-demand catalog is the fallback — and the protected base pool
        stays on-demand throughout."""
        if self.spot_types and self._n_spot(view) < self.max_spot:
            return self._pick(self._resolve(self.spot_types), view)
        return self._pick(self._catalog(), view)

    def pick_scale_down(self, active) -> Optional[int]:
        """Worst goodput-per-dollar elastic instance: slowest measured
        TPOT per $/hr; prefer emptier instances on ties (cheaper to
        drain)."""
        cands = [v for v in active
                 if not self.protect_base or v.iid in self._owned]
        if not cands or len(active) <= self.min_active:
            return None
        v = max(cands,
                key=lambda v: (v.ema.d * v.cost_per_hour, -v.pending))
        return v.iid

    queue_weight = 3.0   # a queued request signals harder than a running one

    def _signals(self, view, t: float):
        """(scale-up signal, scale-down signal), per instance."""
        active, warming = view.active(), view.warming()
        denom = max(len(active) + len(warming), 1)
        up = sum(v.n_running + self.queue_weight * v.n_queued
                 for v in active) / denom
        down = sum(v.pending for v in active) / max(len(active), 1)
        return up, down

    # -- tick ---------------------------------------------------------------

    def on_tick(self, t: float):
        if t - self._last_look < self.interval:
            return
        self._last_look = t
        view = self.plane.view(t)
        up, down = self._signals(view, t)
        yield from self._decide(view, up, down, t)

    def on_eviction_notice(self, gid: int, t: float):
        """Replace reclaimed spot capacity the moment the notice lands:
        provisioning inside the grace window means the replacement's
        warmup overlaps the victim's drain-down instead of following it.
        The replacement is bought through the normal picker, so it is
        spot again while the cap allows (churn is priced in) and
        on-demand past it."""
        if not self.replace_evicted:
            return
        view = self.plane.view(t)
        victim = view.view(gid)
        if not victim.is_spot:
            return
        n_pool = len(view.active()) + len(view.warming())
        if n_pool >= self.max_instances:
            return
        if len(view.warming()) >= self.max_warming + 1:
            return   # replacement may exceed the stampede cap by one
        hw = self.pick_scale_up(view)
        new_gid = yield Provision(hw, warmup_s=self.warmup_override)
        self._owned.add(new_gid)
        self._log(t, "replace", f"{hw.name}#{new_gid} for evicted #{gid}")

    def _decide(self, view, up: float, down: float, t: float):
        active, warming = view.active(), view.warming()
        n_pool = len(active) + len(warming)
        if (up > self.hi_load and n_pool < self.max_instances
                and len(warming) < self.max_warming):
            hw = self.pick_scale_up(view)
            gid = yield Provision(hw, warmup_s=self.warmup_override)
            self._owned.add(gid)
            self._log(t, "provision", f"{hw.name}#{gid} load/inst={up:.1f}")
            self._lo_streak = 0
        elif down < self.lo_pending and len(active) > self.min_active:
            self._lo_streak += 1
            if self._lo_streak >= self.cooldown:
                gid = self.pick_scale_down(active)
                if gid is not None and (yield Drain(gid)):
                    self._log(t, "drain", f"#{gid} pending/inst={down:.1f}")
                self._lo_streak = 0
        else:
            self._lo_streak = 0


class ForecastPoolController(ReactivePoolController):
    """Reactive thresholds applied to *forecast* pressure.

    Holt's linear trend over per-interval arrival counts predicts the
    arrival rate one provisioning horizon ahead (warmup of the scale-up
    type + one interval).  Predicted pressure adds the *extra* arrivals
    the forecast sees beyond today's rate — (pred_rate - rate_now) x
    horizon on top of the current backlog — so a demand ramp crosses the
    watermark ~warmup seconds before the real queue does and capacity
    joins as the swell arrives, not after; a falling forecast triggers
    the drain early on the downswing."""
    name = "forecast"

    def __init__(self, *args, holt_alpha: float = 0.5,
                 holt_beta: float = 0.3, horizon: Optional[float] = None,
                 **kw):
        super().__init__(*args, **kw)
        self.holt_alpha = holt_alpha
        self.holt_beta = holt_beta
        self._horizon = horizon
        self._arrivals = 0
        self._level: Optional[float] = None
        self._trend = 0.0
        self._pred_rate = 0.0

    @property
    def horizon(self) -> float:
        if self._horizon is not None:
            return self._horizon
        if self.warmup_override is not None:
            return self.warmup_override + self.interval
        return max(hw.warmup_s for hw in self._catalog()) + self.interval

    def on_arrival(self, sr, t: float):
        self._arrivals += 1

    def on_tick(self, t: float):
        if t - self._last_look < self.interval:
            return
        dt = min(t - self._last_look, 10 * self.interval)
        self._last_look = t
        rate = self._arrivals / max(dt, 1e-9)
        self._arrivals = 0
        if self._level is None:
            self._level, self._trend = rate, 0.0
        else:
            prev = self._level
            self._level = (self.holt_alpha * rate
                           + (1 - self.holt_alpha)
                           * (self._level + self._trend * dt))
            self._trend = (self.holt_beta * (self._level - prev) / dt
                           + (1 - self.holt_beta) * self._trend)
        self._pred_rate = max(self._level + self._trend * self.horizon, 0.0)

        view = self.plane.view(t)
        up, down = self._signals(view, t)
        yield from self._decide(view, up, down, t)

    def _signals(self, view, t: float):
        up, down = super()._signals(view, t)
        if self._level is None or self._level <= 1e-9:
            return up, down
        # only the forecast *delta* is anticipatory: assume the current
        # pool keeps absorbing today's rate; the extra (or missing)
        # arrivals the trend sees at the horizon land in (or leave) the
        # queues
        denom = max(len(view.active()) + len(view.warming()), 1)
        delta = (self._pred_rate - self._level) * self.horizon / denom
        up = max(up + delta, 0.0)
        # a falling forecast shrinks the scale-down signal so the drain
        # fires on the downswing, not a full cooldown after it
        ratio = min(max(self._pred_rate / self._level, 0.3), 3.0)
        return up, down * ratio


class AdmissionController(cplib.Policy):
    """Early-shed admission: reject work that cannot make its deadline
    even on the fastest accepting instance (predicted critical path of
    this step + downstream steps > remaining slack x ``margin``).
    Admits unconditionally while estimates are cold.

    The length belief comes from a :class:`Beliefs` bundle — pass the
    plane's shared instance (so admission and routing can't silently
    diverge, and the rectifier drifts with reality through the plane's
    exactly-once completion feedback), or the legacy
    ``predictor``/``rectifier`` pieces for a private bundle."""
    name = "early_shed"

    def __init__(self, predictor=None, margin: float = 1.0, min_obs: int = 3,
                 rectifier=None, beliefs: Beliefs = None,
                 adaptive: bool = False, target_regret: float = 0.05,
                 adapt_gain: float = 1.0,
                 margin_bounds: Tuple[float, float] = (0.25, 4.0)):
        super().__init__()
        if beliefs is not None:
            if predictor is not None or rectifier is not None:
                raise TypeError("pass beliefs OR the individual "
                                "predictor/rectifier pieces")
            self.beliefs = beliefs
        else:
            self.beliefs = Beliefs(predictor=predictor, rectifier=rectifier)
        self.margin = margin
        self.min_obs = min_obs
        self.shed_log: List[Tuple[float, int]] = []   # (t, rid)
        # replay-calibrated margin adaptation (off by default: admit
        # behavior is byte-identical to the fixed-margin controller
        # unless the operator both opts in AND feeds a regret
        # measurement from core.replay.shed_regret)
        self.adaptive = adaptive
        self.target_regret = target_regret
        self.adapt_gain = adapt_gain
        self.margin_bounds = margin_bounds
        self.margin_log: List[Tuple[float, float]] = []  # (regret, margin)

    def observe_shed_regret(self, regret: float):
        """Feed one counterfactual measurement — the fraction of shed
        requests that met their deadline in a what-if replay
        (:func:`repro_torch.core.replay.shed_regret`) — and nudge the margin
        multiplicatively toward ``target_regret``: shedding work that
        would have finished means the gate is too tight, so the margin
        RISES (more permissive); regret under target tightens it.  A
        no-op unless constructed with ``adaptive=True``."""
        if not self.adaptive:
            return
        lo, hi = self.margin_bounds
        self.margin = min(max(
            self.margin * (1.0 + self.adapt_gain
                           * (float(regret) - self.target_regret)),
            lo), hi)
        self.margin_log.append((float(regret), self.margin))

    @property
    def predictor(self):
        return self.beliefs.predictor

    @property
    def rectifier(self):
        return self.beliefs.rectifier

    def admit(self, sr, t: float) -> bool:
        """The gate the plane consults on every arrival (a query, not an
        event hook: the plane turns the verdict into Shed/Route)."""
        cv = self.plane.view(t)
        if cv.warming():
            # provisioned capacity is about to join: today's congested
            # estimates overstate the request's fate — don't shed work
            # the incoming instance would have served
            return True
        views = [v for v in cv.accepting() if v.ema.n_obs >= self.min_obs]
        if not views:
            return True          # nothing trustworthy to judge against
        pred = self.beliefs.predict(sr)
        down = max(sr.req.downstream, 0)
        # most optimistic finish: ignore this arrival's queueing, take
        # the fastest instance; downstream steps decode there too.  At
        # arrival nothing has streamed yet, so the rectified prediction
        # IS the unconditional per-step estimate — one size fits the
        # whole remaining chain.
        best = min(v.ema.p * sr.req.input_len
                   + v.ema.d * pred * (1 + down) for v in views)
        slack = sr.deadline - t
        if best <= self.margin * slack:
            return True
        self.shed_log.append((t, sr.req.rid))
        return False
