"""ControlPlane: the single policy-facing gateway API over the cluster.

Copy of ``repro/core/control_plane.py`` (numpy and plain Python),
kept in the port so that it imports nothing of ``repro``.  Its imports
and references name ``repro_torch`` where the reference names
``repro``; any other line that differs carries a comment saying so.
Everything else, float expressions and iteration orders included, is
as written there.

The paper's system is ONE serving gateway that routes, admits, migrates,
and rectifies as a single predict-and-rectify loop.  After PRs 1-4 the
proxy side had grown into four separately-wired objects (router, pool
controller, admission controller, rectify feedback) that the simulator
threaded together by hand with drifting hook signatures.  This module
replaces that wiring with one facade and two contracts:

**Event/decision contract (plane <-> simulator).**  The simulator
reports cluster events to the plane through a typed event API —

    on_arrival(sr, t)            -> one Decision (Route | Shed | Park)
    on_step_done(sr, t)          -> Decision stream (rescue Migrate)
    on_request_done(sr, t)       -> Decision stream (feedback fan-out)
    on_tick(t)                   -> Decision stream (Migrate | Provision
                                    | Drain)
    on_instance_join(gid, t)     -> Decision stream
    on_eviction_notice(gid, t)   -> Decision stream (replacement
                                    Provision inside the grace window)
    on_failure(gid, victims, t)  -> Decision stream (Route per victim)

— and *merely executes* the returned :class:`Decision` values.  Stream
handlers are generators: the simulator executes each yielded decision
immediately and sends the actuation result back into the generator
(``gid = yield Provision(hw)``), so a policy that routes one failure
victim sees the previous victim already enqueued — the exact
interleaving the old imperative wiring had, with the decisions now
explicit, logged, and testable.  Every yielded decision is recorded in
``decision_log`` and every executed one in ``executed_log``; the two
must match 1:1 (property-tested in tests/test_control_plane.py).

**Policy protocol (plane <-> policies).**  Routers, pool controllers,
and the admission path all subclass :class:`Policy`: one set of hook
names and signatures with no-op defaults, ``attach(plane)`` exactly
once (re-attaching raises instead of silently double-registering
completion feedback).  Policies observe the cluster through
``plane.view(t)`` (the ClusterView snapshot API) and actuate only by
yielding decisions.

**Beliefs ownership.**  The plane owns one :class:`Beliefs` bundle —
predictor + OnlineSurvival rectifier + eviction-rate provider — and
fans completion/eviction feedback out to it exactly once per event, no
matter how many policies consult it.  Sharing is explicit: build one
``Beliefs`` and hand it to every consumer (router, admission) and to
the plane.  Policies constructed the legacy way (with their own
predictor/rectifier kwargs) keep their private bundles; the plane
dedupes feedback by component identity so a rectifier shared between
two bundles still learns each completion once.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterator, List, Optional, Sequence

from repro_torch.core.metrics import LatencyLog


# ---------------------------------------------------------------------------
# Decisions: the only way policy intent reaches the cluster
# ---------------------------------------------------------------------------

class Decision:
    """Base marker for plane decisions the simulator executes."""
    __slots__ = ()


def _rid(sr) -> Optional[int]:
    return None if sr is None else sr.req.rid


@dataclasses.dataclass(frozen=True, repr=False)
class Route(Decision):
    """Enqueue a request on instance ``gid`` (admission or token-ID
    resubmission — no transfer latency; the request holds no GPU
    state).  ``sr`` is the opaque request handle and is REQUIRED on
    every executed Route; the plane's own arrival/disposition handlers
    fill it in, policy handlers (``on_failure``) must set it."""
    gid: int
    sr: object = None

    def __repr__(self):
        return f"Route(gid={self.gid}, rid={_rid(self.sr)})"


@dataclasses.dataclass(frozen=True, repr=False)
class Shed(Decision):
    """Fail the request now (cascades to workflow descendants).  The
    reason becomes the journey tag: "shed" = admission rejection,
    "throttle" = fairness-gate rejection, "lost" = no capacity left to
    serve it.  Cascaded descendants record ``cascade:<reason>`` so
    per-class accounting can attribute each cancelled step to its OWN
    SLO class."""
    reason: str = "shed"
    sr: object = None

    def __repr__(self):
        return f"Shed({self.reason!r}, rid={_rid(self.sr)})"


@dataclasses.dataclass(frozen=True, repr=False)
class Park(Decision):
    """Hold the request aside while provisioned capacity warms; the
    simulator re-dispositions parked work when pool membership
    changes."""
    sr: object = None

    def __repr__(self):
        return f"Park(rid={_rid(self.sr)})"


@dataclasses.dataclass(frozen=True, repr=False)
class Preempt(Decision):
    """Park a QUEUED request by token ID: pull it off its instance's
    queue (it holds no GPU state — any partial chunked prefill is
    discarded and redone on resubmission) and mark it pending again.
    The yielding policy receives True/False for whether the victim was
    actually still queued, and OWNS resubmission — typically a later
    ``Route`` from ``on_tick`` once pressure drops.  Running requests
    are not preemptable this way; moving live KV is what ``Migrate``
    is for."""
    sr: object = None

    def __repr__(self):
        return f"Preempt(rid={_rid(self.sr)})"


@dataclasses.dataclass(frozen=True, repr=False)
class Migrate(Decision):
    """Move a queued/running request to instance ``dst`` via ``mode``
    ("token_id" re-prefills at the target, "kv" ships the cache)."""
    sr: object
    dst: int
    mode: str = "token_id"

    def __repr__(self):
        return f"Migrate(rid={_rid(self.sr)}, dst={self.dst}, " \
               f"mode={self.mode!r})"


@dataclasses.dataclass(frozen=True, repr=False)
class Handoff(Decision):
    """Prefill→decode disaggregation transfer: the request just finished
    prefilling on a prefill-role instance; move its state to
    decode-capable instance ``dst`` so decoding happens there.  ``mode``
    follows the migration crossover — "kv" ships the cache (no
    re-prefill), "token_id" re-prefills at the target — resolved per
    network tier, so the same pair of machines can plan differently
    across a WAN hop.  Rides the migration machinery but is accounted
    separately (``n_handoffs``, ``handoff_log``): it is planned
    capacity steering, not a rescue.  Yielded only from
    ``on_prefill_done``; yielding nothing there means the request
    decodes where it prefilled (colocated fallback)."""
    sr: object
    dst: int
    mode: str = "kv"

    def __repr__(self):
        return f"Handoff(rid={_rid(self.sr)}, dst={self.dst}, " \
               f"mode={self.mode!r})"


@dataclasses.dataclass(frozen=True, repr=False)
class Provision(Decision):
    """Buy one instance of ``hw`` (catalog name or full spec).  The
    simulator executes and sends the new instance id back into the
    yielding generator."""
    hw: object
    warmup_s: Optional[float] = None

    def __repr__(self):
        name = self.hw if isinstance(self.hw, str) else self.hw.name
        return f"Provision(hw={name!r})"


@dataclasses.dataclass(frozen=True, repr=False)
class Drain(Decision):
    """Stop admissions on ``gid`` and retire it once empty; ``mode``
    optionally migrates running work out ("kv"/"token_id").  The
    simulator sends back whether the drain was accepted."""
    gid: int
    mode: Optional[str] = None

    def __repr__(self):
        return f"Drain(gid={self.gid}, mode={self.mode!r})"


# ---------------------------------------------------------------------------
# Shared estimation state
# ---------------------------------------------------------------------------

def predict_output(predictor, sr, generated: Optional[float] = None) -> float:
    """One output-length prediction for a (possibly mid-flight) request,
    dispatching on the predictor's session-awareness.  Shared by routing
    and admission control so the two can't silently diverge.
    ``generated`` overrides the tokens-streamed feature (pass 0 for an
    unconditional fresh-step estimate)."""
    g = sr.tokens_out if generated is None else generated
    if getattr(predictor, "session_aware", False):
        out = predictor.predict([sr.req.prompt], [sr.req.input_len],
                                [g], sessions=[sr.req.session])
    else:
        out = predictor.predict([sr.req.prompt], [sr.req.input_len], [g])
    return float(out[0])


class Beliefs:
    """The plane's shared estimation state: what the gateway currently
    believes about request lengths and provider churn.

    * ``predictor`` — admission-time output-length model (MoE, history,
      or any ``predict(prompts, input_lens, generated)`` callable),
    * ``rectifier`` — :class:`~repro_torch.core.rectify.OnlineSurvival`
      conditional remaining-length model fed from completions,
    * ``evict_rates`` — eviction-rate provider
      (:class:`~repro_torch.core.rectify.EvictionRateEstimator` posterior, or
      a ``FixedEvictionRates`` oracle table a benchmark configures).

    Ownership rule: ONE ``Beliefs`` per control plane, shared by every
    policy that consults it.  The plane drives all feedback — policies
    only read.  ``observe_completion`` / ``observe_view`` take a
    ``seen`` identity set so a component shared across several legacy
    bundles is still fed exactly once per event.
    """

    def __init__(self, predictor=None, rectifier=None, evict_rates=None):
        self.predictor = predictor
        self.rectifier = rectifier
        self.evict_rates = evict_rates

    # -- queries -------------------------------------------------------------

    def predict(self, sr) -> float:
        """Rectified total-length belief for a (mid-flight) request:
        the point prediction, conditionally rectified by the survival
        curve once tokens have streamed."""
        pred = predict_output(self.predictor, sr)
        if self.rectifier is not None:
            pred = self.rectifier.rectify(pred, sr.req.input_len,
                                          sr.tokens_out)
        return float(pred)

    def step_estimate(self, sr) -> float:
        """UNCONDITIONAL rectified length for one workflow step that has
        not started generating — the right size for *downstream* steps
        in slack budgeting (the current step's conditional estimate
        inflates once its own prediction is falsified, which says
        nothing about its children).  The predictor sees generated=0
        too: the current step's streamed tokens must not contaminate
        the fresh-step feature vector."""
        pred = predict_output(self.predictor, sr, generated=0)
        if self.rectifier is not None:
            pred = self.rectifier.rectify(pred, sr.req.input_len, 0.0)
        return float(pred)

    def rate_per_hour(self, hw_name: Optional[str] = None) -> float:
        if self.evict_rates is None:
            return 0.0
        return self.evict_rates.rate_per_hour(hw_name)

    # -- feedback (driven by the plane, exactly once per event) -------------

    def observe_completion(self, sr, seen: Optional[set] = None):
        """One finished request: feed the survival curves and any
        predictor that learns online.  ``seen`` dedupes components
        shared across Beliefs bundles."""
        seen = seen if seen is not None else set()
        r = self.rectifier
        if r is not None and id(r) not in seen:
            seen.add(id(r))
            r.observe(sr.req.input_len, sr.tokens_out, rid=sr.req.rid)
        p = self.predictor
        if p is not None and id(p) not in seen:
            seen.add(id(p))
            if hasattr(p, "observe"):
                p.observe(sr.req.input_len, sr.tokens_out)
            if hasattr(p, "observe_step") and sr.req.session >= 0:
                p.observe_step(sr.req.session, sr.tokens_out)

    def observe_view(self, cv, t: float, seen: Optional[set] = None):
        """One lifecycle snapshot: advance the eviction-rate posterior
        (FixedEvictionRates has no ``update`` and is never fed)."""
        seen = seen if seen is not None else set()
        e = self.evict_rates
        update = getattr(e, "update", None)
        if update is not None and id(e) not in seen:
            seen.add(id(e))
            update(cv, t)

    def wants_view(self) -> bool:
        return getattr(self.evict_rates, "update", None) is not None


# ---------------------------------------------------------------------------
# Policy protocol
# ---------------------------------------------------------------------------

class Policy:
    """Common protocol for everything the plane hosts (routers, pool
    controllers, admission).  One hook-name vocabulary, one signature
    per hook, no-op defaults — a policy implements only what it needs.
    Hooks that actuate are generators yielding :class:`Decision`
    values; the actuation result comes back through ``yield``.
    """
    name = "policy"

    def __init__(self):
        self.plane: Optional["ControlPlane"] = None

    def attach(self, plane: "ControlPlane"):
        """Called once when the plane adopts this policy; re-attaching
        raises instead of silently double-registering feedback."""
        if self.plane is not None:
            raise RuntimeError(
                f"{type(self).__name__} is already attached to a "
                f"ControlPlane; build a fresh policy per plane")
        self.plane = plane

    # -- unified hooks (no-op defaults) --------------------------------------

    def on_arrival(self, sr, t: float):
        """A request arrived at the gateway.  NOTIFICATION-ONLY: the
        arrival's sole decision (Route/Shed/Park) belongs to the plane;
        a policy wanting to actuate on arrival pressure yields from
        ``on_tick`` instead.  Implementing this as a generator raises."""

    def on_step_done(self, sr, t: float):
        """A running request advanced another tau decode iterations
        (the periodic SLO-risk checkpoint).  May yield rescue
        ``Migrate`` decisions."""

    def on_request_done(self, sr, t: float):
        """A request the proxy routed streamed its last token."""

    def on_request_failed(self, sr, t: float):
        """A request reached a terminal failure (shed, cascade-shed, or
        lost to capacity collapse) and will never complete.
        NOTIFICATION-ONLY: settle per-request ledger state here; the
        disposition was already decided."""

    def on_prefill_done(self, sr, t: float):
        """A request finished prefilling on a prefill-role instance
        (role-split pools only — never fired for "both"/"decode"
        roles).  May yield one ``Handoff`` to move decoding to a
        decode-capable target; yielding nothing keeps the request
        decoding in place (colocated fallback)."""

    def on_tick(self, t: float):
        """Periodic control tick.  May yield any decision."""

    def on_instance_join(self, gid: int, t: float):
        """A provisioned instance finished warming and is routable."""

    def on_eviction_notice(self, gid: int, t: float):
        """The provider opened an eviction-grace window on ``gid``."""

    def on_failure(self, gid: int, victims, t: float):
        """Instance ``gid`` died holding ``victims``; yield a ``Route``
        per victim to resubmit it (token IDs survive the proxy)."""


# ---------------------------------------------------------------------------
# The facade
# ---------------------------------------------------------------------------

class ControlPlane:
    """One gateway object owning the router, the pool controller, the
    admission path, and the shared :class:`Beliefs` — the only policy
    surface the simulator talks to.

    Construction::

        beliefs = Beliefs(predictor=pred, rectifier=OnlineSurvival(),
                          evict_rates=EvictionRateEstimator())
        plane = ControlPlane(
            router=GoodServeRouter(beliefs=beliefs),
            pool=ForecastPoolController(...),
            admission=AdmissionController(beliefs=beliefs, margin=3.0),
            beliefs=beliefs)
        sim = Simulator(cluster, plane, requests)

    ``Simulator(cluster, router, reqs, pool=..., admission=...)`` keeps
    working: the legacy kwargs are mapped onto a ControlPlane by the
    simulator's constructor shim.
    """

    def __init__(self, router, pool=None, admission=None, beliefs=None,
                 fairness=None, record=False):
        if router is None:
            raise ValueError("a ControlPlane needs a router policy")
        self.router = router
        self.pool = pool
        self.admission = admission
        # multi-tenant fairness policy: consulted as a gate after
        # admission (Shed("throttle")/Shed("shed") on rejection) and
        # hosted as a normal Policy for its tick/completion hooks
        self.fairness = fairness
        # the plane's canonical beliefs; legacy-constructed policies
        # may carry private bundles, collected at attach for feedback
        self.beliefs = (beliefs
                        if beliefs is not None
                        else getattr(router, "beliefs", None) or Beliefs())
        self.sim = None
        self.decision_log: List[Decision] = []
        self.executed_log: List[Decision] = []
        self._belief_set: List[Beliefs] = []
        # wall-clock decision-latency telemetry (metrics.LatencyLog):
        # plane compute only, never part of a replay fingerprint
        self.latency = LatencyLog()
        # hook fast path, filled at attach: per hook name, the policies
        # that actually override it
        self._hooked: Dict[str, list] = {}
        # decision-trace recording (core/replay.py): behavior-neutral by
        # construction — a recorded run replays byte-identical to an
        # unrecorded one (tests/test_replay.py)
        self.recorder = None
        if record:
            # differs: core/replay.py is not ported yet (ROADMAP A11)
            raise NotImplementedError(
                "ControlPlane(record=True) needs core/replay.py, which the "
                "port does not have yet (ROADMAP A11, second half)")

    # -- wiring --------------------------------------------------------------

    def _policies(self):
        return [p for p in (self.router, self.pool, self.admission,
                            self.fairness)
                if p is not None]

    def attach(self, sim):
        """Adopt the simulator (exactly once) and attach every policy.
        Re-attaching raises: a plane double-attached would register
        completion feedback twice."""
        if self.sim is not None:
            raise RuntimeError(
                "ControlPlane is already attached to a simulator; "
                "build a fresh plane (and fresh policies) per run")
        self.sim = sim
        for p in self._policies():
            p.attach(self)
        bundles = [self.beliefs] + [getattr(p, "beliefs", None)
                                    for p in self._policies()]
        self._belief_set = []
        for b in bundles:
            if b is not None and all(b is not x for x in self._belief_set):
                self._belief_set.append(b)
        # precompute which policies override each broadcast hook: the
        # event loop is hot (every completion/tick fans out to every
        # policy), and calling a no-op default just to discover it
        # returned None is pure generator churn.  Skipping non-overriders
        # is byte-identical — the defaults neither decide nor observe.
        self._hooked = {
            h: [p for p in self._policies()
                if getattr(type(p), h, None) is not getattr(Policy, h)]
            for h in ("on_arrival", "on_request_done", "on_request_failed",
                      "on_tick", "on_instance_join", "on_eviction_notice")}
        if self.recorder is not None:
            self.recorder.bind(self, sim)

    @property
    def trace(self):
        """The recorded :class:`~repro_torch.core.replay.DecisionTrace` (plane
        constructed with ``record=True`` only)."""
        if self.recorder is None:
            raise ValueError("ControlPlane was not constructed with "
                             "record=True; no trace was recorded")
        return self.recorder.to_trace()

    @property
    def cluster(self):
        return self.sim.cluster

    def view(self, t: float):
        """Fresh proxy-visible snapshot of the whole pool — the only
        cluster surface policies may observe."""
        return self.sim.cluster.view(t)

    def link(self, src_iid: int, dst_iid: int):
        """Catalog fact: the network tier the topology resolves for an
        instance pair (operator knowledge, like $/hr — not an engine
        internal), so routers can price a migration or handoff before
        deciding it."""
        return self.sim.cluster.link(src_iid, dst_iid)

    # -- decision plumbing ---------------------------------------------------

    def _relay(self, gen, kind: str = "stream") -> Iterator[Decision]:
        """Normalize a policy hook's result (None, iterable, or
        generator) into a logged decision stream, forwarding actuation
        results back into generators.  Each ``send`` segment — the
        policy compute between actuations, not the actuation itself —
        is timed into the plane's decision-latency log under ``kind``."""
        if gen is None:
            return
        if not hasattr(gen, "send"):          # plain iterable
            for d in gen:
                self.decision_log.append(d)
                yield d
            return
        result = None
        clock = time.perf_counter
        record = self.latency.record
        while True:
            t0 = clock()
            try:
                d = gen.send(result)
            except StopIteration:
                record(kind, clock() - t0)
                return
            record(kind, clock() - t0)
            self.decision_log.append(d)
            result = yield d

    def note_executed(self, decision: Decision):
        """The simulator's acknowledgement that one decision ran."""
        self.executed_log.append(decision)

    # -- routing queries (simulator mechanisms: drain re-routing,
    # grace-window evacuation, orphan resubmission) --------------------------

    def route(self, sr, t: float) -> int:
        """Where does this (possibly displaced) request go?  A query,
        not an event: the caller owns the actuation."""
        return self.router.route(sr, t)

    def disposition(self, sr, t: float) -> Decision:
        """Route / Park / Shed("lost") for a request that needs a home
        right now — shared by arrivals and resubmissions whose
        migration target died mid-transfer.  Lifecycle states are
        proxy-visible; no engine internals are read."""
        insts = self.sim.cluster.instances
        if any(g.alive and g.state in ("active", "draining", "evicting")
               for g in insts):
            d = Route(self.router.route(sr, t), sr=sr)
        elif any(g.state in ("provisioning", "warming") for g in insts):
            d = Park(sr=sr)
        else:
            d = Shed("lost", sr=sr)
        self.decision_log.append(d)
        return d

    # -- typed events (the simulator drives these) ---------------------------

    def on_arrival(self, sr, t: float) -> Decision:
        """Admission + routing for one arrival; returns exactly one
        decision."""
        t0 = time.perf_counter()
        d = self._arrival_decision(sr, t)
        self.latency.record("arrival", time.perf_counter() - t0)
        if self.recorder is not None:
            self.recorder.record_arrival(self, sr, t, d)
        return d

    def _arrival_decision(self, sr, t: float) -> Decision:
        for p in self._hooked["on_arrival"]:
            note = p.on_arrival(sr, t)
            if hasattr(note, "send"):
                # run a generator body so its bookkeeping happens, but
                # on_arrival is notification-only — yielding is a bug,
                # not a silently dropped decision
                for d in note:
                    raise TypeError(
                        f"{type(p).__name__}.on_arrival yielded {d!r}: "
                        f"on_arrival is notification-only; yield "
                        f"decisions from on_tick")
            elif note is not None:
                # a returned decision (or list) would be silently lost
                raise TypeError(
                    f"{type(p).__name__}.on_arrival returned {note!r}: "
                    f"on_arrival is notification-only; yield decisions "
                    f"from on_tick")
        if (self.admission is not None
                and not self.admission.admit(sr, t)):
            d = Shed("shed", sr=sr)
            self.decision_log.append(d)
            return d
        if self.fairness is not None:
            why = self.fairness.gate(sr, t)
            if why is not None:
                d = Shed(why, sr=sr)
                self.decision_log.append(d)
                return d
        return self.disposition(sr, t)

    def on_step_done(self, sr, t: float) -> Iterator[Decision]:
        yield from self._relay(self.router.on_step_done(sr, t),
                               kind="step_done")

    def on_prefill_done(self, sr, t: float) -> Iterator[Decision]:
        """A prefill-role instance finished a request's prefill: the
        router picks the decode target (or keeps it colocated by
        yielding nothing)."""
        yield from self._relay(self.router.on_prefill_done(sr, t),
                               kind="prefill_done")

    def on_request_failed(self, sr, t: float) -> None:
        """Terminal-failure notification fan-out (no decisions): the
        request was shed/cascaded/lost and policies holding per-request
        state settle it."""
        if self.recorder is not None:
            # a terminal failure is a ZERO-reward outcome in the trace,
            # never a silently dropped sample
            self.recorder.record_outcome(sr, t, failed=True)
        for p in self._hooked["on_request_failed"]:
            p.on_request_failed(sr, t)

    def on_request_done(self, sr, t: float) -> Iterator[Decision]:
        """Completion: policy hooks first, then belief feedback exactly
        once per component (rectifier curves, online predictors)."""
        if self.recorder is not None:
            self.recorder.record_outcome(sr, t, failed=False)
        for p in self._hooked["on_request_done"]:
            yield from self._relay(p.on_request_done(sr, t),
                                   kind="request_done")
        seen: set = set()
        for b in self._belief_set:
            b.observe_completion(sr, seen=seen)

    def on_tick(self, t: float) -> Iterator[Decision]:
        """Periodic control: advance the eviction-rate posterior from
        one lifecycle snapshot, then run router and controller ticks.
        The snapshot is skipped while the pool holds no spot capacity
        at all (catalog fact): there is nothing for the posterior to
        watch, and ticks fire 4x per simulated second."""
        if any(b.wants_view() for b in self._belief_set) and any(
                g.hw.is_spot for g in self.sim.cluster.instances):
            cv = self.view(t)
            seen: set = set()
            for b in self._belief_set:
                b.observe_view(cv, t, seen=seen)
        for p in self._hooked["on_tick"]:
            yield from self._relay(p.on_tick(t), kind="tick")

    def on_instance_join(self, gid: int, t: float) -> Iterator[Decision]:
        for p in self._hooked["on_instance_join"]:
            yield from self._relay(p.on_instance_join(gid, t), kind="join")

    def on_eviction_notice(self, gid: int, t: float) -> Iterator[Decision]:
        for p in self._hooked["on_eviction_notice"]:
            yield from self._relay(p.on_eviction_notice(gid, t),
                                   kind="evict_notice")

    def on_failure(self, gid: int, victims: Sequence,
                   t: float) -> Iterator[Decision]:
        yield from self._relay(self.router.on_failure(gid, victims, t),
                               kind="failure")
