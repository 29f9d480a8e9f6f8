"""Runtime estimation subsystem: the *rectify* half of predict-and-rectify.

Copy of ``repro/core/rectify.py`` (numpy and plain Python),
kept in the port so that it imports nothing of ``repro``.  Its imports
and references name ``repro_torch`` where the reference names
``repro``; any other line that differs carries a comment saying so.
Everything else, float expressions and iteration orders included, is
as written there.

GoodServe's routing quality rests on two estimates that are wrong in
practice exactly when they matter most:

* the output-length prediction is made once, at admission — a request
  predicted at 200 tokens that has already streamed 250 is telling the
  router its belief is stale, yet a static router only clamps the point
  estimate to "at least one more token";
* the spot feasibility surcharge wants the provider's eviction rate —
  knowledge no operator actually has (the catalog field is the
  simulator's ground truth, not an observable).

This module closes both loops with *online* estimators that consume
only proxy-visible signals — streamed token counts, completion events,
and ClusterView lifecycle snapshots — never engine internals and never
the oracle rate field on the hardware spec (both enforced by the
tests/test_observability.py source scan).

:class:`OnlineSurvival` maintains bucketed empirical survival curves of
output length conditioned on input length, updated from completions the
proxy itself streamed.  ``rectify(pred, input_len, generated)`` blends
the admission-time point prediction with the conditional mean
``E[L | L > generated]`` read off the curve, so a request that outlives
its prediction gets a calibrated remaining length instead of a clamp —
and the blend leans almost entirely on the curve once generation has
falsified the point estimate.

:class:`EvictionRateEstimator` maintains a per-hardware-type
Gamma-Poisson posterior over the spot eviction rate, learned from the
notices the proxy can see (instances flipping to ``evicting``) against
the instance-hours it watched at risk.  The posterior mean starts at
the operator's prior and shrinks toward the observed rate as exposure
accumulates, so spot placement degrades gracefully when the prior is
wrong instead of trusting a constant nobody can measure up front.

:class:`FixedEvictionRates` is the oracle ablation: the rate table an
operator who *did* know the provider's true churn would configure.
Benchmarks build it from the catalog; proxy code never does.
"""
from __future__ import annotations

from collections import OrderedDict, deque
from typing import Dict, Optional, Sequence

import numpy as np

# Input-length buckets for the survival curves: output-length regimes
# shift with prompt size (short SQL calls vs long repo-repair contexts),
# so curves are conditioned on a coarse log-spaced input-length tier.
_LEN_EDGES = (128.0, 256.0, 512.0, 1024.0, 2048.0, 4096.0)


class OnlineSurvival:
    """Streaming conditional output-length model.

    Per input-length bucket, a sliding window of the most recent
    observed output lengths approximates the current survival curve
    S(x) = P(L > x); ``expected_total`` reads the conditional mean
    E[L | L > generated] straight off the surviving samples.  The
    window (not a running sum) is what makes this a *rectifier*: when
    the workload drifts, pre-drift completions age out and the curve
    tracks the new regime within one window.

    All inputs are proxy-visible: the proxy routed the request (it
    knows the input length), streams every token (it knows
    ``generated``), and sees the completion (it knows the final
    length).  ``observe`` is idempotent per request id so a rectifier
    shared between a router and an AdmissionController counts each
    completion once no matter how many hooks fire.
    """

    def __init__(self, edges: Sequence[float] = _LEN_EDGES,
                 window: int = 256, blend_obs: float = 16.0,
                 min_obs: int = 8, falsified_weight: float = 0.9):
        self.edges = tuple(float(e) for e in edges)
        self.window = int(window)
        # pseudo-count governing how many observations it takes to trust
        # the empirical curve over the point prediction (w = n/(n+blend))
        self.blend_obs = float(blend_obs)
        self.min_obs = int(min_obs)
        # once generated >= the point prediction, the prediction is
        # falsified for THIS request: lean (almost) fully on the curve
        self.falsified_weight = float(falsified_weight)
        self._hist = [deque(maxlen=self.window)
                      for _ in range(len(self.edges) + 1)]
        self._seen: OrderedDict = OrderedDict()   # rid -> True (dedupe)
        self._seen_cap = 8192
        self.n_obs = 0

    def _bucket(self, input_len: float) -> int:
        return int(np.digitize(float(input_len), self.edges))

    # -- feedback (completion events the proxy streamed) -------------------

    def observe(self, input_len: float, output_len: float, rid=None):
        """One completed request: ``output_len`` is the token count the
        proxy streamed.  Pass ``rid`` to make the update idempotent."""
        if rid is not None:
            if rid in self._seen:
                return
            self._seen[rid] = True
            while len(self._seen) > self._seen_cap:
                self._seen.popitem(last=False)
        self._hist[self._bucket(input_len)].append(
            max(float(output_len), 1.0))
        self.n_obs += 1

    # -- queries ------------------------------------------------------------

    def _samples(self, input_len: float) -> Optional[np.ndarray]:
        """The bucket's window, pooled across buckets while thin; None
        until there is enough signal to say anything at all."""
        h = self._hist[self._bucket(input_len)]
        if len(h) >= self.min_obs:
            return np.fromiter(h, np.float64, len(h))
        pooled = [x for hh in self._hist for x in hh]
        if len(pooled) >= self.min_obs:
            return np.asarray(pooled, np.float64)
        return None

    @staticmethod
    def _conditional_total(s: np.ndarray, g: float) -> float:
        """E[L | L > g] over the sample window; past the largest
        observed completion it extrapolates one mean top-decile
        exceedance per call (the tail keeps receding, never collapses
        to "done next token")."""
        surv = s[s > g]
        if surv.size:
            return float(surv.mean())
        hi = float(np.quantile(s, 0.9))
        resid = max(float(s[s >= hi].mean()) - hi, 1.0)
        return g + resid

    def expected_total(self, input_len: float,
                       generated: float = 0.0) -> Optional[float]:
        """Conditional mean total length E[L | L > generated] from the
        empirical survival curve; None while the model has no signal."""
        s = self._samples(input_len)
        if s is None:
            return None
        return self._conditional_total(s, max(float(generated), 0.0))

    def expected_remaining(self, input_len: float,
                           generated: float = 0.0) -> Optional[float]:
        total = self.expected_total(input_len, generated)
        if total is None:
            return None
        return max(total - max(float(generated), 0.0), 0.0)

    def rectify(self, pred: float, input_len: float,
                generated: float = 0.0) -> float:
        """Calibrated total-length estimate for a (possibly mid-flight)
        request: blend the base point prediction with the conditional
        empirical mean, by sample count — and by whether generation has
        already disproven the prediction.  Never returns fewer total
        tokens than have already been generated."""
        g = max(float(generated), 0.0)
        floor = max(float(pred), g + 1.0)
        s = self._samples(input_len)
        if s is None:
            return floor
        total = self._conditional_total(s, g)
        # weight by the evidence actually used: when the bucket is thin
        # _samples pools across buckets, and the pooled count is what
        # earned the trust
        w = s.size / (s.size + self.blend_obs)
        if g >= float(pred):
            w = max(w, self.falsified_weight)
        return max((1.0 - w) * floor + w * total, g + 1.0)


# ---------------------------------------------------------------------------
# Empirical eviction-rate estimation (Gamma-Poisson)
# ---------------------------------------------------------------------------

class EvictionRateEstimator:
    """Per-hardware-type Gamma-Poisson posterior over the spot eviction
    rate, learned from ClusterView snapshots.

    Eviction notices on a spot instance arrive as a Poisson process, so
    with a Gamma(alpha0, beta0) prior over the hourly rate — alpha0
    pseudo-notices over beta0 pseudo instance-hours — the posterior
    after seeing ``k`` notices in ``T`` at-risk instance-hours is
    Gamma(alpha0 + k, beta0 + T) with mean (alpha0+k)/(beta0+T): the
    operator's prior when exposure is zero, the observed rate k/T in
    the long run, always finite and non-negative in between.

    Everything consumed is proxy-visible: ``update`` walks one
    ClusterView, accrues exposure for instances the catalog marks spot
    while they are up (``ClusterView.at_risk``), and counts a notice
    the first time a watched instance is seen ``evicting``/``evicted``
    (the provider told the instance, the instance told the proxy).
    """

    def __init__(self, prior_rate_per_hour: float = 12.0,
                 prior_strength_hours: float = 0.25):
        self.prior_rate_per_hour = float(prior_rate_per_hour)
        self.prior_strength_hours = float(max(prior_strength_hours, 1e-9))
        self.alpha0 = self.prior_rate_per_hour * self.prior_strength_hours
        self.beta0 = self.prior_strength_hours
        self.notices: Dict[str, int] = {}
        self.exposure_hours: Dict[str, float] = {}
        self._watching: Dict[int, float] = {}   # iid -> last accrual time
        self._noticed: set = set()     # iids whose notice is counted

    # -- raw evidence (also the unit-test surface) ---------------------------

    def observe_exposure(self, hw_name: str, hours: float):
        if hours > 0.0:
            self.exposure_hours[hw_name] = \
                self.exposure_hours.get(hw_name, 0.0) + float(hours)

    def observe_notice(self, hw_name: str):
        self.notices[hw_name] = self.notices.get(hw_name, 0) + 1

    # -- snapshot-driven learning --------------------------------------------

    def update(self, cv, t: float):
        """Advance the posterior from one ClusterView snapshot."""
        at_risk = {v.iid for v in cv.at_risk()}
        for v in cv.instances:
            if not v.is_spot:
                continue
            name = v.hw.name
            t0 = self._watching.pop(v.iid, None)
            if t0 is not None:
                # accrue instance-hours at risk since the last look —
                # including censored exposure of instances that left the
                # market without a notice (drained, failed): zero
                # notices over real at-risk time IS evidence the rate
                # is low
                self.observe_exposure(name, max(t - t0, 0.0) / 3600.0)
            if v.iid in at_risk:
                self._watching[v.iid] = t
            elif (v.state in ("evicting", "evicted")
                    and v.iid not in self._noticed):
                # the notice landed since the last look: count it once
                self._noticed.add(v.iid)
                self.observe_notice(name)

    # -- posterior queries -----------------------------------------------------

    def rate_per_hour(self, hw_name: Optional[str] = None) -> float:
        """Posterior-mean eviction rate for one hardware type; a type
        never watched falls back to the evidence pooled across all
        types (same silicon market, better than the bare prior)."""
        if hw_name is not None and (hw_name in self.notices
                                    or hw_name in self.exposure_hours):
            k = self.notices.get(hw_name, 0)
            T = self.exposure_hours.get(hw_name, 0.0)
        else:
            k = sum(self.notices.values())
            T = sum(self.exposure_hours.values())
        return (self.alpha0 + k) / (self.beta0 + T)

    def observed_rate(self, hw_name: str) -> Optional[float]:
        """Raw MLE k/T for diagnostics; None without exposure."""
        T = self.exposure_hours.get(hw_name, 0.0)
        if T <= 0.0:
            return None
        return self.notices.get(hw_name, 0) / T


class FixedEvictionRates:
    """Oracle rate table (the ablation: what an operator who *did* know
    the provider's true churn would configure).  Satisfies the same
    ``rate_per_hour`` interface as :class:`EvictionRateEstimator`;
    having no ``update`` method, it is never fed snapshots."""

    def __init__(self, rates: Dict[str, float], default: float = 0.0):
        self.rates = {str(k): float(v) for k, v in rates.items()}
        self.default = float(default)

    def rate_per_hour(self, hw_name: Optional[str] = None) -> float:
        if hw_name is None:
            return self.default
        return self.rates.get(hw_name, self.default)
