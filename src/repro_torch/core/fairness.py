"""Multi-tenant fairness policy for the ControlPlane.

Copy of ``repro/core/fairness.py`` (numpy and plain Python),
kept in the port so that it imports nothing of ``repro``.  Its imports
and references name ``repro_torch`` where the reference names
``repro``; any other line that differs carries a comment saying so.
Everything else, float expressions and iteration orders included, is
as written there.

Production agentic traffic is thousands of tenants with wildly skewed
demand; one abusive tenant can starve every other tenant's SLOs even
though the pool is "only" 2x overloaded.  This module hosts the
gateway-side countermeasures as ONE ControlPlane policy:

* **Weighted service / deficit round robin.**  Every tenant owns a
  token-rate share (``quantum_tps`` split by weight).  Each control
  tick refills per-tenant deficit counters, capped at a burst; each
  admission debits the request's estimated token cost.  A tenant whose
  deficit is exhausted is throttled (OIT-style: the debt *is* the
  outstanding-inflight-tokens meter) — but only while the pool is
  actually under pressure, so the scheduler stays work-conserving.
* **SLO-class-aware shedding.**  Under overload, best-effort traffic
  sheds before standard, and interactive effectively never class-sheds:
  per-class pressure thresholds on the admission gate.
* **Priority preemption with token-ID parking.**  Queued best-effort
  requests that hold up queued interactive work are ``Preempt``-ed:
  pulled off the queue (no GPU state — the token IDs are the request)
  and parked at the gateway, then re-``Route``-d from a later tick once
  pressure drops or a park timeout expires.

Observation discipline: everything here reads ONLY ``plane.view(t)``
(tenant/class/token accounting via ``InstanceView.tenant_tokens`` and
the opaque queued-request handles the proxy already owns) — never
``Instance`` internals and never the workload generator's oracle
fields.  Both are source-scan-enforced in tests/test_torch_observability.py.
Iteration over tenants and instances is everywhere in sorted/snapshot
order, so same-seed replay is byte-identical.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.core import control_plane as cplib


class FairnessPolicy(cplib.Policy):
    """Deficit-round-robin fairness + class-aware shedding + priority
    preemption, as one ControlPlane policy.

    The plane consults :meth:`gate` synchronously per arrival (after
    the admission controller): ``None`` admits, a string reason sheds
    with that journey tag ("throttle" for DRR exhaustion, "shed" for a
    class-pressure rejection).  Tick/completion hooks run the refill
    loop, settle estimated-vs-actual token costs, release parked work,
    and yield ``Preempt`` decisions.

    ``enabled=False`` makes every hook a no-op — the plane with a
    disabled fairness policy replays byte-identically to a plane
    without one (asserted per router in tests/test_torch_policies.py).
    """

    name = "fairness"

    def __init__(self, weights: Optional[Dict[int, float]] = None,
                 quantum_tps: float = 8000.0, burst_s: float = 4.0,
                 overload_pending: float = 6.0,
                 class_shed: Optional[Dict[str, float]] = None,
                 default_out: float = 180.0,
                 preempt: bool = True, max_preempts_per_tick: int = 2,
                 park_timeout_s: float = 20.0,
                 release_pending: Optional[float] = None,
                 enabled: bool = True):
        super().__init__()
        self.enabled = enabled
        # tenant -> service weight; tenants first seen at admission get
        # weight 1.0.  Pass the full map up front for exact shares.
        self.weights: Dict[int, float] = dict(weights or {})
        self.quantum_tps = float(quantum_tps)
        self.burst_s = float(burst_s)
        # mean pending per accepting instance above which DRR debt is
        # enforced; below it the gate is work-conserving and admits
        self.overload_pending = float(overload_pending)
        # per-class pressure ceilings: classes absent here (interactive,
        # unclassed "") are never class-shed
        self.class_shed: Dict[str, float] = dict(
            {"best_effort": 10.0, "standard": 18.0}
            if class_shed is None else class_shed)
        # token cost fallback when the plane has no predictor
        self.default_out = float(default_out)
        self.preempt = bool(preempt)
        self.max_preempts_per_tick = int(max_preempts_per_tick)
        self.park_timeout_s = float(park_timeout_s)
        self.release_pending = (self.overload_pending
                                if release_pending is None
                                else float(release_pending))
        # -- ledgers (all fingerprint-stable: ints/floats, sorted dumps)
        self.deficit: Dict[int, float] = {
            tn: self._burst_cap(tn, seed_weights=True)
            for tn in sorted(self.weights)}
        self.served: Dict[int, int] = {}     # actual tokens per tenant
        self._debits: Dict[int, Tuple[int, float]] = {}  # rid -> (tn, est)
        self._parked: List[Tuple[float, object]] = []    # (parked_at, sr)
        self._last_refill = 0.0
        # telemetry, (t, rid, ...) rows — part of replay fingerprints
        self.throttle_log: List[Tuple[float, int, int]] = []
        self.shed_log: List[Tuple[float, int, str]] = []
        self.preempt_log: List[Tuple[float, int, int]] = []
        self.release_log: List[Tuple[float, int, int]] = []

    # -- share math ----------------------------------------------------------

    def _weight(self, tenant: int) -> float:
        return self.weights.get(tenant, 1.0)

    def _share_tps(self, tenant: int, seed_weights: bool = False) -> float:
        known = self.weights if seed_weights else self.deficit
        # the queried tenant always counts toward the weight total —
        # _note_tenant computes a joiner's burst cap BEFORE inserting
        # it into the deficit ledger, and a total that excludes the
        # joiner over-grants every late-arriving tenant's first burst
        names = sorted(set(known) | {tenant})
        total = sum(self._weight(tn) for tn in names)
        return self.quantum_tps * self._weight(tenant) / max(total, 1e-9)

    def _burst_cap(self, tenant: int, seed_weights: bool = False) -> float:
        return self.burst_s * self._share_tps(tenant, seed_weights)

    def _note_tenant(self, tenant: int):
        if tenant not in self.deficit:
            self.deficit[tenant] = self._burst_cap(tenant)

    def _cost(self, sr) -> float:
        """Estimated tokens this request will make the pool process:
        prompt plus the plane's (rectified) output-length belief, or a
        flat default when the gateway runs without a predictor."""
        b = self.plane.beliefs if self.plane is not None else None
        if b is not None and b.predictor is not None:
            est = b.predict(sr)
        else:
            est = self.default_out
        return float(sr.req.input_len) + float(est)

    @staticmethod
    def _pressure(cv) -> float:
        acc = cv.accepting()
        if not acc:
            return float("inf")
        return sum(v.pending for v in acc) / len(acc)

    # -- the admission-side gate (synchronous plane query) -------------------

    def gate(self, sr, t: float) -> Optional[str]:
        """Fairness verdict for one arrival the admission controller
        already accepted: ``None`` admits (and debits the tenant's
        deficit), else the shed reason.  Anonymous traffic (tenant < 0)
        passes untouched — single-tenant runs are fairness-neutral."""
        if not self.enabled:
            return None
        tenant = sr.req.tenant
        if tenant < 0:
            return None
        self._note_tenant(tenant)
        pressure = self._pressure(self.plane.view(t))
        limit = self.class_shed.get(sr.req.slo_class)
        if limit is not None and pressure >= limit:
            self.shed_log.append((round(t, 2), sr.req.rid, sr.req.slo_class))
            return "shed"
        cost = self._cost(sr)
        if self.deficit[tenant] < cost and pressure >= self.overload_pending:
            self.throttle_log.append((round(t, 2), sr.req.rid, tenant))
            return "throttle"
        # debit, floored so a flood during calm can't bank unbounded
        # debt that outlives the overload it should be punished in
        floor = -4.0 * self._burst_cap(tenant)
        self.deficit[tenant] = max(self.deficit[tenant] - cost, floor)
        self._debits[sr.req.rid] = (tenant, cost)
        return None

    # -- hooks ---------------------------------------------------------------

    def on_request_done(self, sr, t: float):
        if not self.enabled or sr.req.tenant < 0:
            return
        self._note_tenant(sr.req.tenant)
        actual = int(sr.req.input_len) + int(sr.tokens_out)
        self.served[sr.req.tenant] = (self.served.get(sr.req.tenant, 0)
                                      + actual)
        deb = self._debits.pop(sr.req.rid, None)
        if deb is not None:
            tn, est = deb
            # settle the estimate against reality; the next refill's
            # burst cap clamps any over-credit
            self.deficit[tn] += est - actual

    def on_request_failed(self, sr, t: float):
        """Terminal failure (shed, cascade-shed, or lost to capacity
        collapse): forget the admission debit and refund the unserved
        estimate — without this the ledger entry lived forever and the
        tenant stayed debited for work that was never served.  Work the
        pool actually did before the failure (the prefill plus any
        streamed tokens, evidenced by a "run" journey entry) stays
        charged; a request that never started refunds in full."""
        if not self.enabled:
            return
        deb = self._debits.pop(sr.req.rid, None)
        if deb is None:
            return
        tn, est = deb
        ran = any(ev == "run" for _t, ev, _g in sr.journey)
        actual = (int(sr.req.input_len) + int(sr.tokens_out)) if ran else 0
        self.deficit[tn] += est - actual

    def on_tick(self, t: float):
        if not self.enabled:
            return
        dt = max(t - self._last_refill, 0.0)
        self._last_refill = t
        for tn in sorted(self.deficit):      # sorted: replay-stable
            cap = self._burst_cap(tn)
            self.deficit[tn] = min(self.deficit[tn]
                                   + self._share_tps(tn) * dt, cap)
        yield from self._release(t)
        if self.preempt:
            yield from self._preempt(t)

    # -- parked-work release -------------------------------------------------

    def _release(self, t: float):
        if not self._parked:
            return
        cv = self.plane.view(t)
        # releasing needs ACCEPTING capacity: draining/evicting
        # instances still finish what they hold but admit nothing new,
        # so re-routing a parked request into such a pool would strand
        # it on an instance that refuses admissions
        if not cv.accepting():
            return                            # wait for capacity to warm
        pressure = self._pressure(cv)
        keep: List[Tuple[float, object]] = []
        for parked_at, sr in self._parked:
            if sr.state != "pending":         # cascaded/resolved meanwhile
                continue
            if (pressure < self.release_pending
                    or t - parked_at >= self.park_timeout_s):
                gid = self.plane.route(sr, t)
                self.release_log.append((round(t, 2), sr.req.rid, gid))
                yield cplib.Route(gid, sr=sr)
            else:
                keep.append((parked_at, sr))
        self._parked = keep

    # -- priority preemption -------------------------------------------------

    def _preempt(self, t: float):
        """Park queued best-effort work that interactive work is stuck
        behind.  Victims come from the snapshot's opaque queued-request
        handles (the proxy routed them, so pulling one back is its call)
        — newest best-effort first, so the least queue progress is
        thrown away."""
        cv = self.plane.view(t)
        n = 0
        for v in cv.instances:
            if n >= self.max_preempts_per_tick:
                return
            if not (v.alive and v.state == "active"):
                continue
            qs = v.queued_requests()
            if len(qs) < 2:
                continue
            be = [i for i, s in enumerate(qs)
                  if s.req.slo_class == "best_effort"]
            if not be:
                continue
            # only act when an interactive request actually waits
            # behind best-effort work on this instance — and only a
            # victim AHEAD of it frees a slot that work is waiting on
            # (queue [be, interactive, be]: parking the trailing
            # best-effort gains the interactive request nothing)
            inter = [i for i, s in enumerate(qs)
                     if s.req.slo_class == "interactive"]
            ahead = [i for i in be if inter and i < inter[-1]]
            if not ahead:
                continue
            victim = qs[ahead[-1]]            # newest eligible: least
                                              # queue progress discarded
            ok = yield cplib.Preempt(sr=victim)
            if ok:
                self._parked.append((t, victim))
                self.preempt_log.append((round(t, 2), victim.req.rid, v.iid))
                n += 1

    # -- replay fingerprint --------------------------------------------------

    def ledger(self) -> dict:
        """Deterministic dump of the fairness state for replay
        fingerprints: sorted per-tenant served tokens and rounded
        deficits, plus every telemetry log."""
        return {
            "served": sorted(self.served.items()),
            "deficit": sorted((tn, round(d, 6))
                              for tn, d in self.deficit.items()),
            "throttle_log": list(self.throttle_log),
            "shed_log": list(self.shed_log),
            "preempt_log": list(self.preempt_log),
            "release_log": list(self.release_log),
            "n_parked": len(self._parked),
            "n_open_debits": len(self._debits),
        }
