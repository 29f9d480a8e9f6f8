"""Discrete-event, iteration-granularity simulator for a heterogeneous
multi-instance serving cluster.

Copy of ``repro/cluster/simulator.py`` (numpy and plain Python),
kept in the port so that it imports nothing of ``repro``.  Its imports
and references name ``repro_torch`` where the reference names
``repro``; any other line that differs carries a comment saying so.
Everything else, float expressions and iteration orders included, is
as written there.

Each instance runs a vLLM-style continuous-batching engine: prefill is
prioritized and processed one request per iteration; decode iterations
advance every running request by one token; admission is bounded by KV
memory (Eq. 1's capacity constraint).  The proxy router observes only
black-box signals (queue/wait/iteration timings, TPM counters, prefix
tables) — the same information a production proxy has.

The proxy side (routers, pool/admission controllers) observes the pool
exclusively through ``Cluster.view(t)`` -> ``ClusterView`` snapshots
(src/repro/core/observability.py), so proxy-visibility is enforced by
construction rather than by comment.

The simulator talks to exactly ONE policy object: a
:class:`~repro_torch.core.control_plane.ControlPlane` facade.  Cluster events
are reported through the plane's typed event API and the simulator
merely executes the :class:`~repro_torch.core.control_plane.Decision` values
the plane returns (enforced by the tests/test_observability.py source
scan: this module names no concrete policy class).  The legacy
``Simulator(cluster, router, reqs, pool=..., admission=...)`` signature
keeps working — the constructor shim maps those kwargs onto a plane.

The simulator also supports:
  * SLO-risk checks every tau decode iterations per request (Sec. 3.4),
  * token-ID / KV-cache migration with explicit network cost (Fig. 9),
  * instance failure injection (token-ID resubmission doubles as the
    fault-tolerance path — DESIGN.md §6),
  * multi-step agentic workflows: a DAG step only *materializes* (its
    arrival event fires) once every parent step has completed, and each
    instance keeps a per-session KV/prefix cache so consecutive steps of
    a session routed to the same instance skip re-prefilling the shared
    conversation context,
  * an ELASTIC pool: instance lifecycle provisioning -> warming ->
    active -> draining -> retired, with ``provision()`` billing from
    provision time and joining after the hardware's warmup latency,
    ``drain()`` stopping admissions while running requests finish (or
    migrate out), per-instance $/hr accrual (``Cluster.cost_usd``), and
    pool-scaling / admission policies driven through the plane's event
    hooks (arrivals, completions, ticks),
  * deterministic seeds for reproducibility.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.cluster import hardware as hwlib
from repro_torch.cluster.workload import Request, Workflow
from repro_torch.core import control_plane as cplib
from repro_torch.core.estimator import EMAEstimator
from repro_torch.core import migration as miglib
from repro_torch.core.observability import ClusterView


@dataclasses.dataclass
class SimRequest:
    req: Request
    state: str = "pending"      # pending|queued|running|migrating|done|failed
    instance: Optional[int] = None
    enqueued_at: float = 0.0
    prefill_len: int = 0        # tokens to (re-)prefill when dequeued
    skip_prefill: bool = False  # KV-cache migration carries state over
    tokens_out: int = 0
    prefill_end: Optional[float] = None
    finished_at: Optional[float] = None
    n_migrations: int = 0
    n_handoffs: int = 0         # prefill->decode transfers (role pools)
    preempted: bool = False     # touched by a spot eviction at least once
    iters_since_check: int = 0
    pred_out: float = 0.0       # router's current output-length belief
    pred_admit: float = 0.0     # belief at FIRST admission (rectification
                                # is scored on this vs the truth)
    journey: list = dataclasses.field(default_factory=list)  # (t, event, gid)
    # chunked-prefill progress
    prefill_progress: int = 0
    prefill_hit: int = 0
    prefill_started_at: Optional[float] = None

    @property
    def context_len(self) -> int:
        return self.req.input_len + self.tokens_out

    @property
    def deadline(self) -> float:
        # workflow steps share one absolute per-workflow deadline;
        # standalone requests keep the per-request arrival + SLO
        if self.req.deadline_t is not None:
            return self.req.deadline_t
        return self.req.arrival + self.req.slo


def group_prefix_len(group: int) -> int:
    return 64 + (group * 37) % 384


LIFECYCLE = ("provisioning", "warming", "active", "draining",
             "evicting", "retired", "failed", "evicted")


class Instance:
    def __init__(self, iid: int, hw: hwlib.HardwareSpec,
                 fp: hwlib.ModelFootprint, prefix_capacity: int = 8,
                 session_capacity: int = 16, state: str = "active",
                 started_at: float = 0.0, profile=None,
                 region: Optional[str] = None, role: str = "both"):
        self.iid = iid
        self.hw = hw
        self.fp = fp
        # placement: the geographic region (defaults to the hardware
        # catalog entry's) and the serving role.  A "prefill" instance
        # hands finished prefills off to a decode-capable target (the
        # plane's Handoff decision); "both" is the classic colocated
        # instance and the default everywhere, so flat pools behave
        # exactly as before.
        self.region = hw.region if region is None else region
        if role not in ("prefill", "decode", "both"):
            raise ValueError(f"unknown role {role!r}")
        self.role = role
        # measured LatencyProfile governing this instance's iteration
        # times (None -> analytic roofline, the pre-calibration model)
        self.profile = profile
        self.queue: deque = deque()
        self.running: List[SimRequest] = []
        self.alive = True
        # lifecycle: provisioning -> warming -> active -> draining -> retired
        # ("failed" via failure injection).  Billing runs started_at ..
        # retired_at (or sim end).
        self.state = state
        self.started_at = started_at
        self.retired_at: Optional[float] = None
        # spot preemption: absolute kill time once an eviction notice
        # lands (state "evicting"); proxy-visible — the provider tells
        # the instance, the instance tells the proxy
        self.eviction_deadline: Optional[float] = None
        self.busy = False
        self.prefix_cache: OrderedDict = OrderedDict()
        self.prefix_capacity = prefix_capacity
        # per-session KV retention: session id -> cached context length.
        # A later step of the same session skips prefilling that prefix.
        self.session_cache: OrderedDict = OrderedDict()
        self.session_capacity = session_capacity
        self._tpm_tokens = 0.0
        self._tpm_t0 = 0.0
        # effective-TPOT tracking: time between decode-iteration *ends*
        # includes prefill stalls, which is the latency running requests
        # actually experience
        self._last_decode_end = None
        self._idle_gap = True

    # -- black-box observables -------------------------------------------

    @property
    def accepting(self) -> bool:
        """May receive new admissions (drain stops these first)."""
        return self.alive and self.state == "active"

    @property
    def pending(self) -> int:
        return len(self.queue) + len(self.running)

    def tpm(self, now: float) -> float:
        dt = max(now - self._tpm_t0, 1.0)
        return self._tpm_tokens / dt * 60.0

    def note_tokens(self, n: float, now: float):
        # decaying one-minute window
        dt = now - self._tpm_t0
        if dt > 60.0:
            self._tpm_tokens *= 0.5
            self._tpm_t0 = now - 30.0
        self._tpm_tokens += n

    def mem_used_frac(self) -> float:
        used = sum(r.context_len for r in self.running) \
            * self.fp.kv_bytes_per_token
        return min(used / hwlib.kv_capacity_bytes(self.hw, self.fp), 1.0)

    def prefix_hit(self, req: Request) -> int:
        hit = 0
        g = req.prefix_group
        if g in self.prefix_cache:
            hit = min(group_prefix_len(g), req.input_len)
        return max(hit, self.session_hit(req))

    def session_hit(self, req: Request) -> int:
        """Cached conversation prefix for this request's session.  Only
        contexts of the step's first-parent ancestor chain are contiguous
        prefixes of its prompt — a fanout sibling's context lives in the
        same session but is NOT a prefix, so it earns no credit."""
        if req.session < 0 or req.session not in self.session_cache:
            return 0
        cached = self.session_cache[req.session]   # step -> context_len
        for ancestor in req.prefix_chain:          # nearest first
            if ancestor in cached:
                return min(cached[ancestor], req.input_len)
        return 0

    def note_prefix(self, req: Request):
        g = req.prefix_group
        self.prefix_cache[g] = group_prefix_len(g)
        self.prefix_cache.move_to_end(g)
        while len(self.prefix_cache) > self.prefix_capacity:
            self.prefix_cache.popitem(last=False)

    def note_session(self, req: Request, context_len: int):
        if req.session < 0:
            return
        cached = self.session_cache.setdefault(req.session, {})
        cached[req.step] = max(cached.get(req.step, 0), context_len)
        self.session_cache.move_to_end(req.session)
        while len(self.session_cache) > self.session_capacity:
            self.session_cache.popitem(last=False)

    def can_admit(self, sr: SimRequest) -> bool:
        cap = hwlib.max_batch(self.hw, self.fp,
                              avg_total_len=max(
                                  np.mean([r.context_len for r in
                                           self.running + [sr]]), 1.0))
        return len(self.running) < min(cap, self.hw.max_seqs)


class Cluster:
    def __init__(self, instances: Sequence[Instance],
                 net: miglib.NetworkSpec = miglib.ETHERNET_10G,
                 ema_alpha: float = 0.3, profiles=None,
                 seed_priors: bool = True, prior_profiles=None,
                 topology: Optional[miglib.Topology] = None):
        self.instances = list(instances)
        self.net = net
        # network tiers: instance pairs resolve through the topology.
        # Without one, every pair prices the legacy flat ``net`` — the
        # degenerate single-tier topology, byte-identical to pre-region
        # clusters.
        self.topology = (topology if topology is not None
                         else miglib.flat_topology(net))
        self.estimator = EMAEstimator(alpha=ema_alpha)
        # calibration: hardware-name -> LatencyProfile.  Every instance
        # of that hardware (present AND elastically provisioned later)
        # gets the profile as its iteration-time truth; with
        # ``seed_priors`` its estimator entry is also born at the
        # profile-derived (q, p, d) instead of the hardcoded defaults.
        # ``prior_profiles``, when given, seeds BELIEFS from a different
        # profile set than the truth — the stale-calibration experiment
        # (fig17's "catalog" arm: the hardware drifted, the priors did
        # not).
        self.profiles = dict(profiles or {})
        self.seed_priors = seed_priors
        self.prior_profiles = dict(prior_profiles) if prior_profiles else None
        for g in self.instances:
            self._apply_profile(g)
        # monotone snapshot counter: every ClusterView.capture stamps
        # the next version, so views of this cluster are totally ordered
        # and a stale-view consumer can prove it never steps backwards
        self._view_seq = itertools.count(1)

    def _apply_profile(self, g: Instance):
        if g.profile is None:
            g.profile = self.profiles.get(g.hw.name)
        if not self.seed_priors:
            return
        src = g.profile
        if self.prior_profiles is not None:
            src = self.prior_profiles.get(g.hw.name, src)
        if src is not None:
            self.estimator.set_prior(g.iid, src.priors())

    def next_view_version(self) -> int:
        return next(self._view_seq)

    def link(self, src_iid: int, dst_iid: int) -> miglib.NetworkSpec:
        """The network tier connecting two instances — what every
        migration, evacuation, and handoff between them is priced on."""
        return self.topology.tier(self.instances[src_iid].region,
                                  self.instances[dst_iid].region)

    def alive(self) -> List[Instance]:
        return [g for g in self.instances if g.alive]

    def view(self, t: float) -> ClusterView:
        """The ONLY cluster surface routers/controllers may observe."""
        return ClusterView.capture(self, t)

    def add_instance(self, hw: hwlib.HardwareSpec, fp: hwlib.ModelFootprint,
                     t: float) -> Instance:
        g = Instance(len(self.instances), hw, fp, state="provisioning",
                     started_at=t)
        self.instances.append(g)
        self._apply_profile(g)
        return g

    @staticmethod
    def instance_cost_usd(g: Instance, now: float) -> float:
        """One instance's accrued bill: provision time until retirement
        (or ``now``) — warmup is paid for too.  The single accrual rule;
        every cost metric (total, spot share) must sum THIS."""
        end = g.retired_at if g.retired_at is not None else now
        return g.hw.cost_per_hour * max(end - g.started_at, 0.0) / 3600.0

    def cost_usd(self, now: float) -> float:
        return sum(self.instance_cost_usd(g, now) for g in self.instances)


class Simulator:
    def __init__(self, cluster: Cluster, router=None,
                 requests: Sequence[Request] = (),
                 *, tau: int = 50, migration_mode: str = "token_id",
                 fail_at: Optional[Dict[int, float]] = None,
                 max_time: float = 86400.0,
                 workflows: Optional[Sequence[Workflow]] = None,
                 pool=None, admission=None, fairness=None, plane=None,
                 preemptions: bool = True, spot_seed: int = 0,
                 tick_s: float = 0.25):
        self.cluster = cluster
        # single policy surface: one ControlPlane.  New-style callers
        # pass the plane (second positional or ``plane=``); the legacy
        # (router, pool=, admission=) kwargs are mapped onto a fresh
        # plane so existing constructors keep working.
        if isinstance(router, cplib.ControlPlane):
            plane, router = router, None
        if plane is None:
            plane = cplib.ControlPlane(router=router, pool=pool,
                                       admission=admission,
                                       fairness=fairness)
        elif (router is not None or pool is not None
                or admission is not None or fairness is not None):
            raise TypeError(
                "pass either a ControlPlane or the legacy "
                "router/pool/admission/fairness pieces, not both")
        self.plane = plane
        self.requests = [SimRequest(req=r) for r in requests]
        self.tau = tau
        self.migration_mode = migration_mode
        self.fail_at = fail_at or {}
        self.max_time = max_time
        self._events: list = []
        self._seq = itertools.count()
        self.now = 0.0
        # housekeeping cadence (controller ticks, belief refresh).  A
        # coarser tick trades scaling reactivity for event-loop
        # throughput on long traces; 0.25 s is the paper-faithful
        # default every benchmark uses.
        self.tick_s = tick_s
        # events processed by run() — the denominator for event-loop
        # throughput (events/s) reporting
        self.n_events = 0
        # incrementally maintained count of terminal (done|failed)
        # requests: the run loop is hot and must not rescan every
        # request's state after every event
        self._n_terminal = 0
        self.migration_log: List[Tuple[float, int, int, float]] = []
        # prefill->decode transfers: (t, src, dst, mode, latency)
        self.handoff_log: List[Tuple[float, int, int, str, float]] = []
        # spot preemption injection: while a spot instance is up, eviction
        # notices arrive as a Poisson process (hw.evictions_per_hour).
        # Draws come from a per-instance stream seeded by (spot_seed,
        # iid), NOT one shared stream in activation order — so instances
        # the compared configurations have in common (the base pool) see
        # IDENTICAL notice times regardless of what each router or
        # controller does elsewhere in the pool.
        self.preemptions = preemptions
        self.spot_seed = spot_seed
        self.eviction_log: List[Tuple[float, int]] = []   # (notice_t, gid)
        self.n_evictions = 0                              # kills delivered
        # kill victims with no live resubmission target while a
        # replacement is still warming: parked here, resubmitted at the
        # next join instead of being counted as lost
        self._orphans: List[SimRequest] = []
        # DAG bookkeeping: a step materializes only when its parents have
        # completed (deferred arrival).  Structure comes from the requests
        # themselves; ``workflows`` adds descriptors for metrics.
        self.workflows = {w.wid: w for w in (workflows or [])}
        self._wf_children: Dict[Tuple[int, int], List[SimRequest]] = {}
        self._wf_waiting: Dict[Tuple[int, int], int] = {}
        for sr in self.requests:
            r = sr.req
            if r.wid >= 0 and r.parents:
                self._wf_waiting[(r.wid, r.step)] = len(r.parents)
                for p in r.parents:
                    self._wf_children.setdefault((r.wid, p), []).append(sr)
        self.plane.attach(self)

    # -- decision execution --------------------------------------------------

    def _execute(self, d, t: float):
        """Run one plane decision; the return value is sent back into
        the yielding policy generator (instance id for Provision,
        acceptance for Drain)."""
        self.plane.note_executed(d)
        if isinstance(d, cplib.Route):
            if d.sr is None:
                raise TypeError(f"{d!r} names no request: Route.sr is "
                                f"required on executed decisions")
            self.enqueue(d.sr, d.gid, t)
            return d.gid
        if isinstance(d, cplib.Migrate):
            self.migrate(d.sr, d.dst, t, mode=d.mode)
            return None
        if isinstance(d, cplib.Handoff):
            if d.sr is None:
                raise TypeError(f"{d!r} names no request: sr is "
                                f"required on executed decisions")
            self.migrate(d.sr, d.dst, t, mode=d.mode, kind="handoff")
            return None
        if isinstance(d, cplib.Preempt):
            if d.sr is None:
                raise TypeError(f"{d!r} names no request: sr is "
                                f"required on executed decisions")
            return self._preempt_queued(d.sr, t)
        if isinstance(d, cplib.Provision):
            return self.provision(d.hw, t, warmup_s=d.warmup_s)
        if isinstance(d, cplib.Drain):
            return self.drain(d.gid, t, migrate_running=d.mode)
        if isinstance(d, (cplib.Park, cplib.Shed)):
            if d.sr is None:
                raise TypeError(f"{d!r} names no request: sr is "
                                f"required on executed decisions")
            if isinstance(d, cplib.Park):
                self._orphans.append(d.sr)
            else:
                self._shed(d.sr, t, tag=d.reason)
            return None
        raise TypeError(f"unknown decision {d!r}")

    def _drive(self, decisions, t: float):
        """Exhaust one plane event handler, executing each decision as
        it is yielded (so later policy logic sees earlier actuations)."""
        if decisions is None:
            return
        result = None
        while True:
            try:
                d = decisions.send(result)
            except StopIteration:
                return
            result = self._execute(d, t)

    # -- event plumbing -----------------------------------------------------

    def _push(self, t: float, kind: str, payload=None):
        heapq.heappush(self._events, (t, next(self._seq), kind, payload))

    def enqueue(self, sr: SimRequest, gid: int, t: float,
                prefill_len: Optional[int] = None,
                skip_prefill: bool = False):
        g = self.cluster.instances[gid]
        sr.instance = gid
        sr.state = "queued"
        sr.enqueued_at = t
        sr.journey.append((round(t, 2), "enq", gid))
        sr.prefill_len = (sr.context_len if prefill_len is None
                          else prefill_len)
        sr.skip_prefill = skip_prefill
        sr.prefill_progress = 0
        sr.prefill_hit = 0
        sr.prefill_started_at = None
        g.queue.append(sr)
        if not g.busy and g.alive:
            g.busy = True
            self._push(t, "step", gid)

    def migrate(self, sr: SimRequest, dst: int, t: float, mode: str,
                kind: str = "migrate"):
        """Move a running/queued request to another instance.  The
        transfer is priced on the network tier the topology resolves for
        this instance pair — an inter-region move pays the WAN tier.
        ``kind="handoff"`` is the prefill→decode transfer in role-split
        pools: same machinery, but accounted separately (it is planned
        capacity steering, not a rescue)."""
        src = self.cluster.instances[sr.instance]
        if sr in src.running:
            src.running.remove(sr)
        elif sr in src.queue:
            src.queue.remove(sr)
        else:
            return
        sr.state = "migrating"
        net = self.cluster.link(src.iid, dst)
        fp = src.fp
        if mode == "kv":
            lat = miglib.kv_transfer_latency(net, fp, sr.context_len)
            skip = True
        else:
            lat = miglib.token_id_transfer_latency(net, sr.context_len)
            skip = False  # re-prefill happens at the target queue
        if kind == "handoff":
            sr.n_handoffs += 1
            sr.journey.append((round(t, 2), "handoff", dst))
            self.handoff_log.append((t, src.iid, dst, mode, lat))
        else:
            sr.n_migrations += 1
            self.migration_log.append((t, src.iid, dst, lat))
        self._push(t + lat, "migrate_arrive", (sr, dst, skip))
        self._maybe_retire(src.iid, t)

    # -- elastic pool lifecycle ---------------------------------------------

    def provision(self, hw, t: float,
                  fp: Optional[hwlib.ModelFootprint] = None,
                  warmup_s: Optional[float] = None) -> int:
        """Start a new instance: provisioning -> warming -> active after
        ``hw.warmup_s`` (VM allocation + weight load; override with
        ``warmup_s``).  Billing starts now; routing starts at join."""
        if isinstance(hw, str):
            hw = hwlib.catalog(hw)
        fp = fp or self.cluster.instances[0].fp
        warm = hw.warmup_s if warmup_s is None else warmup_s
        g = self.cluster.add_instance(hw, fp, t)
        self._push(t + 0.25 * warm, "warming", g.iid)
        self._push(t + warm, "join", g.iid)
        return g.iid

    def drain(self, gid: int, t: float,
              migrate_running: Optional[str] = None) -> bool:
        """Stop new admissions on ``gid``; queued requests are re-routed
        (token-ID resubmission, they hold no GPU state yet).  Running
        requests finish in place by default, or migrate out immediately
        when ``migrate_running`` is "kv"/"token_id".  The instance
        retires once empty.  Refuses if no other instance is accepting."""
        g = self.cluster.instances[gid]
        if g.state != "active" or not g.alive:
            return False
        if not any(o.accepting for o in self.cluster.instances
                   if o.iid != gid):
            return False
        g.state = "draining"
        for sr in list(g.queue):
            dst = self.plane.route(sr, t)
            self.migrate(sr, dst, t, mode="token_id")
        if migrate_running:
            for sr in list(g.running):
                dst = self.plane.route(sr, t)
                self.migrate(sr, dst, t, mode=migrate_running)
        self._maybe_retire(gid, t)
        return True

    def _maybe_retire(self, gid: int, t: float):
        g = self.cluster.instances[gid]
        if g.state == "draining" and not g.queue and not g.running:
            g.state = "retired"
            g.retired_at = t
            g.busy = False

    def _preempt_queued(self, sr: SimRequest, t: float) -> bool:
        """Execute a Preempt: park a QUEUED request by token ID — pull
        it off its instance's queue (no GPU state; partial chunked
        prefill is discarded and redone at resubmission) and mark it
        pending.  Returns whether the victim was actually still queued;
        the yielding policy owns resubmission.  Running requests refuse:
        moving live KV is the migration path."""
        if sr.state != "queued" or sr.instance is None:
            return False
        g = self.cluster.instances[sr.instance]
        if sr not in g.queue:
            return False
        g.queue.remove(sr)
        sr.journey.append((round(t, 2), "park", g.iid))
        sr.state = "pending"
        sr.instance = None
        self._maybe_retire(g.iid, t)
        return True

    def _shed(self, sr: SimRequest, t: float, tag: str = "shed"):
        """Fail the step now, and cascade to every transitive child — a
        workflow missing one step can never meet its deadline, so its
        remaining work is doomed too.  ``tag`` distinguishes admission
        rejection ("shed") from fairness throttling ("throttle") from
        capacity loss ("lost") in the journey.  Descendants record
        ``cascade:<tag>`` instead of the root's tag: each cancelled step
        carries its own tenant/SLO class, and per-class accounting must
        separate "this step was rejected" from "this step died because
        an ancestor was"."""
        ctag = tag if tag.startswith("cascade:") else "cascade:" + tag
        stack = [(sr, tag)]
        while stack:
            s, tg = stack.pop()
            if s.state in ("done", "failed"):
                continue
            s.state = "failed"
            self._n_terminal += 1
            s.journey.append((round(t, 2), tg, -1))
            # terminal-failure notification: this is the ONLY site that
            # fails requests, so policies holding per-request ledger
            # state (fairness admission debits) settle here — a shed or
            # lost request never reaches on_request_done
            self.plane.on_request_failed(s, t)
            for c in self._wf_children.get((s.req.wid, s.req.step), []):
                stack.append((c, ctag))

    def _submit(self, sr: SimRequest, t: float):
        """Re-disposition a displaced request (migration target died
        mid-transfer): the plane decides Route / Park / Shed("lost"),
        the simulator executes.  Keeps routers from being handed an
        empty target list after the whole pool is reclaimed."""
        self._execute(self.plane.disposition(sr, t), t)

    def _dispose_orphans(self, t: float):
        """Re-disposition parked requests whenever pool membership
        changes: resubmit if something is alive again, keep waiting if a
        replacement is still warming, fail as lost once nothing is —
        without this, orphans whose warming rescuer dies pre-join would
        hang as "pending" forever and the run would never terminate."""
        orphans = [sr for sr in self._orphans if sr.state == "pending"]
        self._orphans = []
        if not orphans:
            return
        if any(o.alive and o.state in ("active", "draining", "evicting")
               for o in self.cluster.instances):
            self._drive(self.plane.on_failure(-1, orphans, t), t)
        elif any(o.state in ("provisioning", "warming")
                 for o in self.cluster.instances):
            self._orphans = orphans
        else:
            for sr in orphans:
                self._shed(sr, t, tag="lost")

    # -- engine model ---------------------------------------------------------

    prefill_chunk = 512    # chunked-prefill token budget per iteration

    def _step(self, gid: int, t: float):
        """One hybrid engine iteration (chunked-prefill continuous
        batching): the decode batch advances one token while up to
        ``prefill_chunk`` prompt tokens of the admitted queue-head are
        prefilled in the same iteration (Sarathi/vLLM-style mixing)."""
        g = self.cluster.instances[gid]
        if not g.alive:
            g.busy = False
            return
        est = self.cluster.estimator

        # pick the prefill candidate (FCFS among admittable)
        pf = None
        for cand in list(g.queue):
            if g.can_admit(cand):
                pf = cand
                break
        if pf is not None and pf.prefill_started_at is None:
            pf.prefill_started_at = t
            pf.prefill_hit = g.prefix_hit(pf.req)
            est.observe_queue_wait(gid, t - pf.enqueued_at)

        b = len(g.running)
        if pf is None and b == 0:
            g.busy = False
            g._idle_gap = True
            return

        # --- iteration time: decode batch + prefill chunk share -----------
        avg_ctx = (float(np.mean([r.context_len for r in g.running]))
                   if g.running else 0.0)
        dt_decode = (hwlib.decode_iteration_time(g.hw, g.fp, b, avg_ctx,
                                                 profile=g.profile)
                     if b else 0.0)
        chunk_tokens = 0
        if pf is not None:
            if pf.skip_prefill:
                remaining_pf = 0
            else:
                remaining_pf = (pf.prefill_len - pf.prefill_hit
                                - pf.prefill_progress)
            chunk_tokens = min(self.prefill_chunk, max(remaining_pf, 0))
            if g.profile is not None:
                dt_chunk = g.profile.chunk_time(chunk_tokens)
            else:
                dt_chunk = (2.0 * g.fp.n_active * chunk_tokens
                            / g.hw.eff_flops)
        else:
            dt_chunk = 0.0
        if b:
            dt = dt_decode + dt_chunk
        elif g.profile is not None:
            # prefill-only iteration under a measured profile: the
            # profile's prefill grid already folds in the weight-read
            # floor and fixed overhead
            dt = g.profile.prefill_time(chunk_tokens)
        else:
            weight_read = g.fp.n_params * g.fp.dtype_bytes / g.hw.eff_bw
            dt = max(dt_chunk, weight_read) + g.hw.overhead_ms / 1e3
        t_next = t + dt

        # --- prefill progress ---------------------------------------------
        handoff_pf = None
        if pf is not None:
            pf.prefill_progress += chunk_tokens
            finished_pf = (pf.skip_prefill
                           or pf.prefill_progress
                           >= pf.prefill_len - pf.prefill_hit)
            if finished_pf:
                g.queue.remove(pf)
                if not pf.skip_prefill:
                    est.observe_prefill(
                        gid, max(pf.prefill_len - pf.prefill_hit, 1),
                        t_next - pf.prefill_started_at)
                    g.note_prefix(pf.req)
                    g.note_tokens(pf.prefill_len, t)
                pf.state = "running"
                pf.prefill_end = t_next
                pf.journey.append((round(t_next, 2), "run", gid))
                g.running.append(pf)
                # role-split pools: a prefill-role instance reports the
                # finished prefill so the plane can hand decoding to a
                # decode-capable target.  Fired after the decode block
                # below, once this iteration's batch bookkeeping is done
                # (never fires for "both"/"decode" roles, so flat pools
                # replay byte-identically).
                if g.role == "prefill":
                    handoff_pf = pf

        # --- decode progress -----------------------------------------------
        if b:
            if g._last_decode_end is not None and not g._idle_gap:
                eff = t_next - g._last_decode_end
            else:
                eff = dt
            est.observe_decode_iter(gid, eff)
            g._last_decode_end = t_next
            g._idle_gap = False
            g.note_tokens(b, t)
            done, at_risk = [], []
            for sr in g.running[:b]:
                sr.tokens_out += 1
                sr.iters_since_check += 1
                if sr.tokens_out >= sr.req.output_len:
                    done.append(sr)
                elif sr.iters_since_check >= self.tau:
                    sr.iters_since_check = 0
                    at_risk.append(sr)
            for sr in done:
                g.running.remove(sr)
                sr.state = "done"
                self._n_terminal += 1
                sr.finished_at = t_next
                sr.journey.append((round(t_next, 2), "done", gid))
                g.note_session(sr.req, sr.context_len)
                # completion fans out through the plane: policy hooks
                # plus exactly-once Beliefs feedback (survival curves,
                # online predictors)
                self._drive(self.plane.on_request_done(sr, t_next), t_next)
                self._release_children(sr, t_next)
            for sr in at_risk:
                self._drive(self.plane.on_step_done(sr, t_next), t_next)

        if handoff_pf is not None and handoff_pf.state == "running":
            self._drive(self.plane.on_prefill_done(handoff_pf, t_next),
                        t_next)

        if g.running or g.queue:
            self._push(t_next, "step", gid)
        else:
            g.busy = False
            g._idle_gap = True
            self._maybe_retire(gid, t_next)

    def _release_children(self, sr: SimRequest, t: float):
        """Deferred DAG arrivals: a child step materializes when its last
        unfinished parent completes; its arrival timestamp becomes the
        release time (the per-workflow deadline stays absolute)."""
        for child in self._wf_children.get((sr.req.wid, sr.req.step), []):
            key = (child.req.wid, child.req.step)
            self._wf_waiting[key] -= 1
            if self._wf_waiting[key] == 0 and child.state != "failed":
                child.req.arrival = t
                self._push(t, "arrival", child)

    def _fail_instance(self, gid: int, t: float):
        g = self.cluster.instances[gid]
        if g.state == "retired":      # already drained: billing stays shut
            g.alive = False
            return
        g.alive = False
        g.state = "failed"
        if g.retired_at is None:
            g.retired_at = t
        g.busy = False
        victims = list(g.queue) + list(g.running)
        g.queue.clear()
        g.running.clear()
        for sr in victims:
            sr.state = "pending"
            sr.instance = None
        if victims:
            if any(o.alive and o.state in ("active", "draining",
                                           "evicting")
                   for o in self.cluster.instances):
                self._drive(self.plane.on_failure(gid, victims, t), t)
            else:                   # park or lose, never crash the router
                self._orphans.extend(victims)
        self._dispose_orphans(t)

    # -- spot preemption -----------------------------------------------------

    def _arm_eviction(self, gid: int, t: float):
        """Sample the eviction notice for a spot instance that just came
        up: one draw from its own (spot_seed, iid) stream, so the same
        instance draws the same notice offset in every compared run —
        elastically provisioned instances get config-dependent iids (and
        so config-dependent draws), but the shared base pool's
        preemption trace is invariant across routers/controllers."""
        g = self.cluster.instances[gid]
        if (not self.preemptions or not g.hw.is_spot
                or g.hw.evictions_per_hour <= 0):
            return
        rng = np.random.default_rng((self.spot_seed, gid))
        dt = rng.exponential(3600.0 / g.hw.evictions_per_hour)
        self._push(t + dt, "evict_notice", gid)

    def _evict_notice(self, gid: int, t: float):
        """Provider reclaims a spot instance: admissions stop NOW, the
        kill lands after ``hw.grace_s``.  The grace window is spent
        evacuating: queued work escapes as token IDs (it holds no GPU
        state), running work takes the KV-vs-token-ID plan — KV only if
        the transfer clears the machine before the kill AND wins the
        end-to-end crossover for its context length."""
        g = self.cluster.instances[gid]
        if not g.alive or g.state not in ("active", "draining"):
            return                     # already drained/retired/failed
        g.state = "evicting"
        g.eviction_deadline = t + g.hw.grace_s
        self.eviction_log.append((t, gid))
        self._push(g.eviction_deadline, "evict_kill", gid)
        # the plane may buy a replacement whose warmup hides inside the
        # victim's grace window (Provision decisions executed here)
        self._drive(self.plane.on_eviction_notice(gid, t), t)
        # evacuation needs a surviving target: accepting, or at least an
        # alive draining instance (it still finishes the work it holds —
        # the same fallback failure resubmission uses)
        if not any(o.accepting or (o.alive and o.state == "draining")
                   for o in self.cluster.instances if o.iid != gid):
            return                     # nowhere to go: ride out the grace
        for sr in list(g.queue):
            sr.preempted = True
            sr.journey.append((round(t, 2), "evict", gid))
            dst = self.plane.route(sr, t)
            self.migrate(sr, dst, t, mode="token_id")
        for sr in list(g.running):
            sr.preempted = True
            sr.journey.append((round(t, 2), "evict", gid))
            dst = self.plane.route(sr, t)
            mode = miglib.plan_evacuation(
                self.cluster.link(gid, dst),
                self.cluster.instances[dst].hw, g.fp,
                sr.context_len, g.eviction_deadline - t,
                prefix_hit=self.cluster.instances[dst].prefix_hit(sr.req))
            self.migrate(sr, dst, t, mode=mode)

    def _evict_kill(self, gid: int, t: float):
        g = self.cluster.instances[gid]
        if not g.alive or g.state != "evicting":
            return
        g.alive = False
        g.state = "evicted"
        g.retired_at = t            # billing runs through the grace window
        g.eviction_deadline = None
        g.busy = False
        self.n_evictions += 1
        victims = list(g.queue) + list(g.running)
        g.queue.clear()
        g.running.clear()
        for sr in victims:
            sr.state = "pending"
            sr.instance = None
            sr.preempted = True
            sr.journey.append((round(t, 2), "evict_kill", gid))
        if victims:
            if any(o.accepting or (o.alive and o.state in
                                   ("draining", "evicting"))
                   for o in self.cluster.instances):
                self._drive(self.plane.on_failure(gid, victims, t), t)
            else:
                # park the victims: a replacement the controller bought
                # at notice time may still be warming — _dispose_orphans
                # resubmits at its join, or fails them as lost if
                # nothing is coming
                self._orphans.extend(victims)
        self._dispose_orphans(t)

    # -- main loop -------------------------------------------------------------

    def run(self):
        for sr in self.requests:
            if sr.req.wid >= 0 and sr.req.parents:
                continue                      # deferred until parents finish
            self._push(sr.req.arrival, "arrival", sr)
        for gid, t in self.fail_at.items():
            self._push(t, "fail", gid)
        for g in self.cluster.instances:    # pre-provisioned spot capacity
            if g.state == "active":
                self._arm_eviction(g.iid, g.started_at)
        tick = self.tick_s
        self._push(tick, "tick", None)

        finished = 0
        total = len(self.requests)
        while self._events and self.now < self.max_time:
            t, _, kind, payload = heapq.heappop(self._events)
            self.now = t
            self.n_events += 1
            if kind == "arrival":
                sr = payload
                if sr.state == "failed":     # shed transitively meanwhile
                    continue
                self._execute(self.plane.on_arrival(sr, t), t)
            elif kind == "step":
                self._step(payload, t)
            elif kind == "migrate_arrive":
                sr, dst, skip = payload
                g = self.cluster.instances[dst]
                # a draining/evicting target still finishes what it
                # holds (evacuations may land there when nothing is
                # accepting); a dead/retired one forces a re-route —
                # which invalidates any KV that travelled — through the
                # same park-or-lose fallback as arrivals, since the
                # whole pool may have died during the transfer
                if g.accepting or (g.alive and g.state in
                                   ("draining", "evicting")):
                    self.enqueue(sr, dst, t, skip_prefill=skip)
                else:
                    sr.state = "pending"
                    sr.instance = None
                    self._submit(sr, t)
            elif kind == "fail":
                self._fail_instance(payload, t)
            elif kind == "evict_notice":
                self._evict_notice(payload, t)
            elif kind == "evict_kill":
                self._evict_kill(payload, t)
            elif kind == "warming":
                g = self.cluster.instances[payload]
                if g.state == "provisioning":
                    g.state = "warming"
            elif kind == "join":
                g = self.cluster.instances[payload]
                if g.state in ("provisioning", "warming"):
                    g.state = "active"
                    self._arm_eviction(g.iid, t)
                    self._drive(self.plane.on_instance_join(g.iid, t), t)
                    self._dispose_orphans(t)
            elif kind == "tick":
                self._drive(self.plane.on_tick(t), t)
                if self._n_terminal < total:
                    self._push(t + tick, "tick", None)
            if self._n_terminal == total:
                break
        return self.requests, self.now


def build_paper_cluster(model: str = "llama3.1-8b",
                        gpus: Sequence[str] = hwlib.PAPER_CLUSTER,
                        net: miglib.NetworkSpec = miglib.ETHERNET_10G
                        ) -> Cluster:
    fp = hwlib.footprint(model)
    instances = [Instance(i, hwlib.GPUS[g], fp) for i, g in enumerate(gpus)]
    return Cluster(instances, net=net)
