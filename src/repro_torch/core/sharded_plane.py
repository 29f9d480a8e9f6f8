"""ShardedControlPlane: N gateway replicas over bounded-staleness views.

Copy of ``repro/core/sharded_plane.py`` (numpy and plain Python),
kept in the port so that it imports nothing of ``repro``.  Its imports
and references name ``repro_torch`` where the reference names
``repro``; any other line that differs carries a comment saying so.
Everything else, float expressions and iteration orders included, is
as written there.

The paper evaluates ONE serving gateway that sees every arrival and a
fresh ClusterView per decision.  At production RPS that single gateway
is itself the bottleneck: real deployments run N
stateless gateway replicas behind a load balancer, each routing
against a *periodically synced* snapshot of cluster state — Ray
Serve's distributed proxies are the reference architecture.  This
module reproduces that regime inside the simulator so the goodput cost
of stale views and decision conflicts is measurable
(benchmarks/fig16_sharded.py):

**Replicas.**  A :class:`ShardedControlPlane` hosts N fully
independent :class:`~repro_torch.core.control_plane.ControlPlane` replicas,
each with its own router (and optionally pool/admission policies and
Beliefs).  A deterministic arrival partitioner — session affinity by
default: workflow id, falling back to request id — assigns every
request to exactly one replica, which makes ALL decisions for that
request (arrival, risk checks, failure resubmission).  Nothing is
shared between replicas except the cluster itself.

**Bounded-staleness views.**  Each replica observes the pool through a
frozen, versioned ClusterView snapshot refreshed every
``sync_interval_s`` of simulated time (versions are the cluster's
monotone capture counter, so a replica's sync log proves it never
steps backwards).  Due replicas are refreshed from ONE shared capture
per event timestamp — batched view sync, the array-backed fast path.
With ``sync_interval_s <= 0`` the replica context hands back the live
cluster and the sharded plane is a pure demultiplexer: N=1 replays
byte-identical to the unsharded plane (test-enforced for every
router).

**Conflict resolution.**  Two replicas can route to the same "free"
slot because both hold snapshots that predate each other's decisions.
The sharded plane arbitrates against live state at execution time:
a Route whose target is no longer routable, or whose target the
snapshot showed under capacity but is now at ``hw.max_seqs``, is
REJECTED — the loser's decision is recorded as executed-as-rejected,
logged in ``conflict_log``, the losing replica force-syncs (the
rejection response carries fresh state), and the request re-enters
that replica's plane as a retry disposition.  Park/Shed("lost")
arrivals are likewise re-dispositioned when live membership disagrees
with the snapshot — a real gateway's submit RPC fails fast and
retries; a simulated one must not strand work on a view of the pool
that no longer exists.  Emitted==executed stays 1:1 at both the
sharded and the per-replica level.
"""
from __future__ import annotations

import time
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

from repro_torch.core import control_plane as cplib
from repro_torch.core.control_plane import (ControlPlane, Decision, Park, Route,
                                      Shed)
from repro_torch.core.metrics import LatencyLog
from repro_torch.core.observability import capture_instance


def default_partition(sr, n: int) -> int:
    """Session-affine arrival partitioning: every step of a workflow
    lands on the same replica (its router's session heuristics keep
    working); standalone requests hash by request id.  Deterministic
    and stable for a request's whole lifetime."""
    key = sr.req.wid if sr.req.wid >= 0 else sr.req.rid
    return key % n


class _Shard:
    """One gateway replica plus its view-sync state."""
    __slots__ = ("idx", "replica", "snapshot", "last_sync", "sync_log",
                 "max_staleness")

    def __init__(self, idx: int, replica: ControlPlane):
        self.idx = idx
        self.replica = replica
        self.snapshot = None          # frozen ClusterView
        self.last_sync = 0.0
        self.sync_log: List[Tuple[float, int]] = []   # (t, view version)
        self.max_staleness = 0.0      # observed, across the whole run


class _StaleCluster:
    """The cluster surface a replica sees: its shard's frozen snapshot.
    ``view(t)`` hands back the snapshot (tracking observed staleness);
    ``instances`` exposes the snapshot's InstanceViews, which carry
    exactly the lifecycle scalars the replica's disposition logic
    reads."""
    __slots__ = ("_shard", "_live")

    def __init__(self, shard: _Shard, live):
        self._shard = shard
        self._live = live

    @property
    def instances(self):
        return self._shard.snapshot.instances

    def view(self, t: float):
        s = self._shard
        s.max_staleness = max(s.max_staleness, t - s.last_sync)
        return s.snapshot

    def link(self, src_iid: int, dst_iid: int):
        """Network-tier resolution delegates to the live cluster:
        topology and instance regions are static operator catalog
        facts, not replicated view state — there is nothing to be
        stale about."""
        return self._live.link(src_iid, dst_iid)


class _ReplicaContext:
    """What a replica ControlPlane attaches to instead of the real
    Simulator: a context whose ``cluster`` is either the shard's stale
    snapshot surface or — at sync_interval_s <= 0 — the live cluster
    itself, which makes the zero-staleness path the unsharded code
    path, byte for byte."""
    __slots__ = ("cluster",)

    def __init__(self, cluster):
        self.cluster = cluster


class ShardedControlPlane(ControlPlane):
    """N independent ControlPlane replicas behind a deterministic
    arrival partitioner, each on a bounded-staleness view.

    The simulator talks to this object exactly as it talks to a single
    plane (same typed event API, same decision/executed accounting);
    internally every event is demultiplexed to the owning replica and
    every Route arbitrated against live state.
    """

    def __init__(self, replicas: Sequence[ControlPlane],
                 sync_interval_s: float = 1.0,
                 partitioner: Optional[Callable] = None):
        if not replicas:
            raise ValueError("a ShardedControlPlane needs >= 1 replica")
        # deliberately NOT calling ControlPlane.__init__: the sharded
        # plane hosts whole planes, not policies — it only shares the
        # base class's simulator-facing surface (and the isinstance
        # checks the Simulator shim and bench harness rely on)
        self.shards = [_Shard(i, r) for i, r in enumerate(replicas)]
        self.sync_interval_s = float(sync_interval_s)
        self.partitioner = partitioner or default_partition
        self.sim = None
        self.decision_log: List[Decision] = []
        self.executed_log: List[Decision] = []
        self.latency = LatencyLog()
        # (t, rid, gid, shard_idx) per rejected decision, in order
        self.conflict_log: List[Tuple[float, int, int, int]] = []
        # id(decision) -> shard, for routing note_executed acks back to
        # the replica that emitted the decision (ids stay valid: the
        # decision logs hold references to every registered decision)
        self._owner = {}
        # (serialized arrivals, sim knobs) captured at attach when any
        # replica records a decision trace: replicas attach to a
        # _ReplicaContext with no request list, so the sharded plane —
        # the one object that sees the Simulator — owns the arrival
        # snapshot the merged trace needs for replay_whatif
        self._trace_meta = None

    # -- conveniences the bench harness reads --------------------------------

    @property
    def router(self):
        """Replica 0's router — the representative policy for result
        labeling (all replicas are configured identically in every
        benchmark)."""
        return self.shards[0].replica.router

    @property
    def n_replicas(self) -> int:
        return len(self.shards)

    def replica_latency(self) -> LatencyLog:
        """All replicas' own decision-latency samples folded into one
        distribution (the sharded plane's ``latency`` log times the
        gateway-level path, sync and arbitration included)."""
        merged = LatencyLog()
        for s in self.shards:
            merged.merge(s.replica.latency)
        return merged

    # -- wiring --------------------------------------------------------------

    def attach(self, sim):
        if self.sim is not None:
            raise RuntimeError(
                "ShardedControlPlane is already attached to a simulator; "
                "build a fresh plane (and fresh replicas) per run")
        self.sim = sim
        live = self.sync_interval_s <= 0
        for s in self.shards:
            ctx = _ReplicaContext(sim.cluster if live
                                  else _StaleCluster(s, sim.cluster))
            s.replica.attach(ctx)
        if any(s.replica.recorder is not None for s in self.shards):
            from repro_torch.core.replay import serialize_requests, sim_kw_of
            self._trace_meta = (serialize_requests(sim.requests),
                                sim_kw_of(sim))
        if not live:
            self._sync(self.shards, 0.0)

    @property
    def trace(self):
        """The per-replica decision streams merged into ONE
        :class:`~repro_torch.core.replay.DecisionTrace` ordered by event time
        (arrivals and sim knobs come from the sharded plane's own
        attach-time snapshot — replica recorders see no request list)."""
        from repro_torch.core.replay import DecisionTrace
        recs = [s.replica.recorder for s in self.shards
                if s.replica.recorder is not None]
        if not recs:
            raise ValueError("no replica was constructed with "
                             "record=True; no trace was recorded")
        reqs, kw = self._trace_meta or (None, None)
        return DecisionTrace.merge([r.to_trace() for r in recs],
                                   requests=reqs, sim_kw=kw)

    # -- view sync -----------------------------------------------------------

    def _sync(self, shards, t: float):
        """Refresh the given shards from ONE shared frozen capture."""
        cv = self.sim.cluster.view(t).freeze()
        for s in shards:
            s.snapshot = cv
            s.last_sync = t
            s.sync_log.append((t, cv.version))

    def _maybe_sync(self, t: float):
        if self.sync_interval_s <= 0:
            return
        due = [s for s in self.shards
               if t - s.last_sync >= self.sync_interval_s]
        if due:
            self._sync(due, t)

    def _shard_for(self, sr) -> _Shard:
        return self.shards[self.partitioner(sr, len(self.shards))
                           % len(self.shards)]

    # -- conflict arbitration --------------------------------------------------

    def _live_category(self, t: float) -> str:
        """Route/park/shed against LIVE membership — the same lifecycle
        test ControlPlane.disposition applies, on the real instances."""
        insts = self.sim.cluster.instances
        if any(g.alive and g.state in ("active", "draining", "evicting")
               for g in insts):
            return "route"
        if any(g.state in ("provisioning", "warming") for g in insts):
            return "park"
        return "shed"

    def _conflicted(self, shard: _Shard, d: Decision, t: float) -> bool:
        """Did live state reject this stale decision?

        * Route: the target is no longer routable (it died, was
          reclaimed, or retired since the snapshot), or the snapshot
          showed a free slot that another replica's decision has since
          filled to ``hw.max_seqs``.  Routing to a target the replica
          KNEW was saturated is not a conflict — that is deliberate
          queueing on a stale view, and its cost shows up as latency.
        * Park / Shed("lost"): live membership disagrees with the
          snapshot's route/park/shed category — accepting the stale
          decision would strand or drop work the live pool can serve.
        Admission Shed("shed") is a policy verdict, never arbitrated.
        """
        if isinstance(d, Route):
            sv = shard.snapshot.get(d.gid)
            if sv is None:           # target joined after the snapshot
                return False         # (only reachable via live hints)
            g = self.sim.cluster.instances[d.gid]
            live = capture_instance(self.sim.cluster, g, t)

            def routable(v):
                return v.accepting or (v.alive and v.state in
                                       ("draining", "evicting"))
            if routable(sv) and not routable(live):
                return True
            return (sv.accepting and sv.pending < sv.hw.max_seqs
                    and live.pending >= live.hw.max_seqs)
        if isinstance(d, Park):
            return self._live_category(t) != "park"
        if isinstance(d, Shed) and d.reason == "lost":
            return self._live_category(t) != "shed"
        return False

    def _reject(self, shard: _Shard, d: Decision, sr, t: float) -> Decision:
        """Record the loss, force-sync the loser, retry through its own
        plane.  The rejected decision is executed-as-rejected at both
        levels, so emitted==executed stays 1:1; the retry cannot
        re-conflict (it routes on the view the rejection brought
        back)."""
        gid = d.gid if isinstance(d, Route) else -1
        self.conflict_log.append((round(t, 6), sr.req.rid, gid, shard.idx))
        shard.replica.note_executed(d)
        self.decision_log.append(d)
        self.executed_log.append(d)
        self._sync([shard], t)
        retry = shard.replica.disposition(sr, t)
        self._adopt(shard, retry)
        return retry

    def _adopt(self, shard: _Shard, d: Decision):
        """A replica decision enters the sharded plane's own log and is
        remembered for the execution ack."""
        self.decision_log.append(d)
        self._owner[id(d)] = shard

    def note_executed(self, decision: Decision):
        self.executed_log.append(decision)
        shard = self._owner.pop(id(decision), None)
        if shard is not None:
            shard.replica.note_executed(decision)

    # -- decision plumbing -----------------------------------------------------

    def _relay_shard(self, shard: _Shard, gen,
                     kind: str) -> Iterator[Decision]:
        """Forward one replica handler's decision stream, arbitrating
        every yielded Route against live state and timing each compute
        segment into the gateway-level latency log."""
        if gen is None:
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
            if (self.sync_interval_s > 0 and isinstance(d, Route)
                    and d.sr is not None
                    and self._conflicted(shard, d, self.sim.now)):
                d = self._reject(shard, d, d.sr, self.sim.now)
            else:
                self._adopt(shard, d)
            result = yield d

    # -- routing queries -------------------------------------------------------

    def route(self, sr, t: float) -> int:
        self._maybe_sync(t)
        return self._shard_for(sr).replica.route(sr, t)

    def disposition(self, sr, t: float) -> Decision:
        self._maybe_sync(t)
        shard = self._shard_for(sr)
        d = shard.replica.disposition(sr, t)
        if self.sync_interval_s > 0 and self._conflicted(shard, d, t):
            return self._reject(shard, d, sr, t)
        self._adopt(shard, d)
        return d

    # -- typed events ----------------------------------------------------------

    def on_arrival(self, sr, t: float) -> Decision:
        t0 = time.perf_counter()
        self._maybe_sync(t)
        shard = self._shard_for(sr)
        d = shard.replica.on_arrival(sr, t)
        if self.sync_interval_s > 0 and self._conflicted(shard, d, t):
            d = self._reject(shard, d, sr, t)
        else:
            self._adopt(shard, d)
        self.latency.record("arrival", time.perf_counter() - t0)
        return d

    def on_step_done(self, sr, t: float) -> Iterator[Decision]:
        self._maybe_sync(t)
        shard = self._shard_for(sr)
        yield from self._relay_shard(
            shard, shard.replica.on_step_done(sr, t), "step_done")

    def on_prefill_done(self, sr, t: float) -> Iterator[Decision]:
        self._maybe_sync(t)
        shard = self._shard_for(sr)
        yield from self._relay_shard(
            shard, shard.replica.on_prefill_done(sr, t), "prefill_done")

    def on_request_done(self, sr, t: float) -> Iterator[Decision]:
        self._maybe_sync(t)
        shard = self._shard_for(sr)
        yield from self._relay_shard(
            shard, shard.replica.on_request_done(sr, t), "request_done")

    def on_request_failed(self, sr, t: float) -> None:
        # notification, no decisions: settle the owning replica's
        # per-request ledger state (fairness debits)
        self._shard_for(sr).replica.on_request_failed(sr, t)

    def on_tick(self, t: float) -> Iterator[Decision]:
        self._maybe_sync(t)
        for shard in self.shards:
            yield from self._relay_shard(
                shard, shard.replica.on_tick(t), "tick")

    def on_instance_join(self, gid: int, t: float) -> Iterator[Decision]:
        # membership changes are broadcast: every replica's controller
        # must learn about new capacity, whichever replica bought it
        self._maybe_sync(t)
        for shard in self.shards:
            yield from self._relay_shard(
                shard, shard.replica.on_instance_join(gid, t), "join")

    def on_eviction_notice(self, gid: int, t: float) -> Iterator[Decision]:
        # the provider's notice lands on ONE gateway (deterministically
        # by instance id), which owns the replacement decision
        self._maybe_sync(t)
        shard = self.shards[gid % len(self.shards)]
        yield from self._relay_shard(
            shard, shard.replica.on_eviction_notice(gid, t), "evict_notice")

    def on_failure(self, gid: int, victims: Sequence,
                   t: float) -> Iterator[Decision]:
        # victims scatter back to their owning replicas (partition is
        # stable per request); shard index order keeps replay exact
        self._maybe_sync(t)
        groups = {}
        for sr in victims:
            shard = self._shard_for(sr)
            groups.setdefault(shard.idx, (shard, []))[1].append(sr)
        for idx in sorted(groups):
            shard, part = groups[idx]
            yield from self._relay_shard(
                shard, shard.replica.on_failure(gid, part, t), "failure")


def make_sharded_plane(n: int, plane_factory: Callable[[int], ControlPlane],
                       sync_interval_s: float = 1.0,
                       partitioner: Optional[Callable] = None
                       ) -> ShardedControlPlane:
    """Build N identically-configured replicas (``plane_factory(i)``
    must return a FRESH ControlPlane per call — policies attach once)
    behind the default session-affine partitioner."""
    return ShardedControlPlane([plane_factory(i) for i in range(n)],
                               sync_interval_s=sync_interval_s,
                               partitioner=partitioner)
