"""ClusterView / InstanceView: the proxy-visible snapshot API.

Copy of ``repro/core/observability.py`` (numpy and plain Python),
kept in the port so that it imports nothing of ``repro``.  Its imports
and references name ``repro_torch`` where the reference names
``repro``; any other line that differs carries a comment saying so.
Everything else, float expressions and iteration orders included, is
as written there.

Routers and pool/admission controllers must observe the cluster ONLY
through these views — never by reaching into ``Instance.queue`` /
``Instance.running`` (enforced by tests/test_observability.py).  A view
carries exactly the information a production proxy has:

  * what the proxy itself did: per-instance queue depth, the age and
    prompt length of every request it routed there, the streamed token
    counts of running requests (so context lengths are derivable),
  * what the instance reports: lifecycle state, TPM counter, KV-memory
    fraction, and the EMA capability estimates (q, p, d) built from
    observable timing events,
  * operator-side catalog facts: the hardware spec (incl. $/hr and
    warmup latency) — the operator knows what it pays for.

Cache probes (``prefix_hit`` / ``session_hit``) delegate to the
instance's radix/session tables, mirroring the prefix-table RPC a real
proxy issues; they expose hit *lengths*, not cache contents.

``newest_queued`` / ``longest_running`` return opaque request handles
for migration decisions (the proxy owns the requests it routed), so
load balancers like Llumnix can pick migration victims without walking
engine internals.

Views are VERSIONED: every capture stamps a monotone ``version`` drawn
from the cluster's snapshot counter plus the capture time ``t``, so a
gateway replica holding a bounded-staleness snapshot (the sharded
control plane of core/sharded_plane.py) can prove it never steps
backwards.  ``freeze()`` materializes the lazy per-instance load
signals at capture time — a snapshot held *across* simulated time must
not leak later cluster state through its cached properties (the cache
probes stay live: they model a prefix-table RPC answered by the
instance, not replicated gateway state).  ``as_arrays()`` exposes the
snapshot as flat numpy arrays for consumers that make many decisions
against one frozen view.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property
from types import SimpleNamespace
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.cluster import hardware as hwlib
from repro_torch.core.estimator import InstanceEstimate


@dataclasses.dataclass(frozen=True)
class InstanceView:
    """Point-in-time black-box snapshot of one serving instance.

    Scalar facts are captured eagerly; the per-request detail vectors
    (queue ages, prefill lengths, context lengths) are cached properties
    computed on first access — a capture happens on every routing
    decision and risk check, and most consumers (least-request, P2C,
    the controllers) never touch the vectors, so eager materialization
    would turn O(instances) decisions into O(total pending) ones.
    Views are per-decision ephemera; don't hold one across simulated
    time."""
    iid: int
    state: str                 # provisioning|warming|active|draining|
                               # evicting|retired|failed|evicted
    alive: bool
    accepting: bool            # may receive new admissions
    n_queued: int
    n_running: int
    t: float                   # capture timestamp
    ema: InstanceEstimate      # (q, p, d, n_obs) capability estimates
    hw: hwlib.HardwareSpec
    fp: hwlib.ModelFootprint
    # spot preemption: the provider notifies the instance, the instance
    # notifies the proxy — both facts are proxy-visible
    eviction_deadline: float = None   # absolute kill time while evicting
    # placement facts (operator catalog knowledge, like $/hr): the
    # geographic region and the serving role in disaggregated pools
    region: str = ""
    role: str = "both"                # prefill|decode|both
    _inst: object = dataclasses.field(repr=False, compare=False, default=None)

    @property
    def pending(self) -> int:
        return self.n_queued + self.n_running

    @property
    def can_prefill(self) -> bool:
        """May admit fresh arrivals (which start with a prefill)."""
        return self.role != "decode"

    @property
    def can_decode(self) -> bool:
        """May host the decode phase (handoff target eligibility)."""
        return self.role != "prefill"

    @property
    def cost_per_hour(self) -> float:
        return self.hw.cost_per_hour

    @property
    def is_spot(self) -> bool:
        """Preemptible capacity (operator catalog fact)."""
        return self.hw.is_spot

    @cached_property
    def tpm(self) -> float:
        return self._inst.tpm(self.t)

    @cached_property
    def mem_used_frac(self) -> float:
        return self._inst.mem_used_frac()

    @cached_property
    def queued_ages(self) -> tuple:
        """Seconds each queued request has waited, FIFO order."""
        return tuple(max(self.t - s.enqueued_at, 0.0)
                     for s in self._inst.queue)

    @cached_property
    def queued_prefill_tokens(self) -> tuple:
        """Prompt tokens still to prefill, per queued request."""
        return tuple(s.prefill_len for s in self._inst.queue)

    @cached_property
    def running_context_lens(self) -> tuple:
        """Prompt + streamed tokens, per running request."""
        return tuple(r.context_len for r in self._inst.running)

    @cached_property
    def tenant_tokens(self) -> tuple:
        """(tenant, slo_class, context tokens) per resident request —
        queued then running.  Tenant id and SLO class are client-declared
        at admission, so the proxy knows them for every request it
        routed; token counts are the same proxy-side accounting as
        ``queued_prefill_tokens`` / ``running_context_lens``.  This is
        ALL a fairness scheduler may see about a tenant."""
        return (tuple((s.req.tenant, s.req.slo_class, s.prefill_len)
                      for s in self._inst.queue)
                + tuple((r.req.tenant, r.req.slo_class, r.context_len)
                        for r in self._inst.running))

    # -- cache probes (hit lengths only, like a prefix-table RPC) ---------

    def prefix_hit(self, req) -> int:
        return self._inst.prefix_hit(req)

    def session_hit(self, req) -> int:
        return self._inst.session_hit(req)

    # -- opaque migration-victim handles ----------------------------------

    def newest_queued(self):
        """Most recently queued request (cheapest to move: no progress)."""
        return self._inst.queue[-1] if self._inst.queue else None

    def queued_requests(self):
        """Opaque handles of all queued requests, FIFO order — the proxy
        routed them, so rescuing one elsewhere is its call to make."""
        return list(self._inst.queue)

    def longest_running(self):
        """Running request with the largest context (most KV to free)."""
        if not self._inst.running:
            return None
        return max(self._inst.running, key=lambda r: r.context_len)

    def freeze(self) -> "InstanceView":
        """Materialize every lazy load signal at capture time.

        A per-decision view never needs this (the instance can't change
        under it), but a bounded-staleness snapshot held by a gateway
        replica does: without freezing, the cached properties would read
        the live instance at *access* time and leak fresher state than
        the snapshot's version claims.  Cache probes and migration
        handles intentionally stay live — they model RPCs the replica
        issues at decision time, not replicated view state."""
        _ = (self.tpm, self.mem_used_frac, self.queued_ages,
             self.queued_prefill_tokens, self.running_context_lens,
             self.tenant_tokens)
        return self


# The lazy vectors a freeze() must have materialized (and exactly the
# set InstanceView defines as cached properties — pinned by test).
FROZEN_SIGNALS = ("tpm", "mem_used_frac", "queued_ages",
                  "queued_prefill_tokens", "running_context_lens",
                  "tenant_tokens")


def capture_instance(cluster, g, t: float) -> InstanceView:
    """Snapshot ONE live instance (the per-instance half of
    ClusterView.capture, shared with the sharded plane's conflict
    check, which needs a fresh view of a single routing target without
    paying for a full-cluster capture)."""
    return InstanceView(
        iid=g.iid, state=g.state, alive=g.alive,
        accepting=g.accepting,
        n_queued=len(g.queue), n_running=len(g.running),
        t=t, ema=cluster.estimator.snapshot(g.iid),
        hw=g.hw, fp=g.fp,
        eviction_deadline=g.eviction_deadline,
        region=g.region, role=g.role, _inst=g)


class ClusterView:
    """Snapshot of every instance, in iid order.

    ``version`` is a cluster-wide monotone capture counter and ``t``
    the capture timestamp: two views of the same cluster always order
    by version, and a consumer comparing ``view.t`` against its own
    clock gets its observation staleness."""

    def __init__(self, views: Sequence[InstanceView],
                 version: int = 0, t: float = 0.0):
        self.instances: List[InstanceView] = list(views)
        self.version = version
        self.t = t
        self._by_iid = {v.iid: v for v in self.instances}

    @classmethod
    def capture(cls, cluster, t: float) -> "ClusterView":
        views = [capture_instance(cluster, g, t)
                 for g in cluster.instances]
        bump = getattr(cluster, "next_view_version", None)
        return cls(views, version=bump() if bump is not None else 0, t=t)

    def freeze(self) -> "ClusterView":
        """Pin every instance's lazy signals at capture time (see
        InstanceView.freeze) so the snapshot can be held across
        simulated time by a gateway replica."""
        for v in self.instances:
            v.freeze()
        return self

    def view(self, iid: int) -> InstanceView:
        return self._by_iid[iid]

    def get(self, iid: int) -> Optional[InstanceView]:
        """Like view(), but None for instances that joined after this
        snapshot was captured (a stale replica may hear about a request
        bound for an instance it hasn't synced yet)."""
        return self._by_iid.get(iid)

    def as_arrays(self):
        """Flat array projection of the snapshot (iid, pending,
        accepting, alive, max_seqs), computed once and cached — the
        fast path for consumers that score many candidates against one
        frozen view without touching per-InstanceView attributes."""
        arr = getattr(self, "_arrays", None)
        if arr is None:
            vs = self.instances
            arr = SimpleNamespace(
                iid=np.fromiter((v.iid for v in vs), dtype=np.int64,
                                count=len(vs)),
                pending=np.fromiter((v.pending for v in vs),
                                    dtype=np.int64, count=len(vs)),
                accepting=np.fromiter((v.accepting for v in vs),
                                      dtype=bool, count=len(vs)),
                alive=np.fromiter((v.alive for v in vs), dtype=bool,
                                  count=len(vs)),
                max_seqs=np.fromiter((v.hw.max_seqs for v in vs),
                                     dtype=np.int64, count=len(vs)))
            self._arrays = arr
        return arr

    def accepting(self) -> List[InstanceView]:
        """Instances that may receive new admissions (routing targets)."""
        return [v for v in self.instances if v.accepting]

    def active(self) -> List[InstanceView]:
        return [v for v in self.instances if v.alive and v.state == "active"]

    def warming(self) -> List[InstanceView]:
        """Capacity already paid for but not yet serving."""
        return [v for v in self.instances
                if v.state in ("provisioning", "warming")]

    def draining(self) -> List[InstanceView]:
        return [v for v in self.instances if v.state == "draining"]

    def evicting(self) -> List[InstanceView]:
        """Spot instances in their eviction-grace window."""
        return [v for v in self.instances if v.state == "evicting"]

    def spot(self) -> List[InstanceView]:
        """Preemptible instances currently serving (active spot)."""
        return [v for v in self.instances
                if v.is_spot and v.alive and v.state == "active"]

    def prefill_capable(self) -> List[InstanceView]:
        """Accepting instances that may take fresh arrivals (role
        "prefill" or "both") — the admission-routing target set in a
        disaggregated pool."""
        return [v for v in self.instances if v.accepting and v.can_prefill]

    def decode_capable(self) -> List[InstanceView]:
        """Accepting instances that may host decoding (role "decode" or
        "both") — the handoff target set."""
        return [v for v in self.instances if v.accepting and v.can_decode]

    def at_risk(self) -> List[InstanceView]:
        """Spot instances currently exposed to provider reclamation —
        alive and serving or draining (a notice can still land on a
        draining spot instance).  The exposure clock the eviction-rate
        estimator integrates runs over exactly these."""
        return [v for v in self.instances
                if v.is_spot and v.alive
                and v.state in ("active", "draining")]

    def total_pending(self) -> int:
        return sum(v.pending for v in self.accepting())

    def tenant_resident_tokens(self) -> dict:
        """Context tokens resident per tenant (queued prefill + running
        context), summed over every instance in the snapshot and keyed
        by tenant id in sorted order — the cluster-wide per-tenant
        accounting a fairness scheduler meters against.  Anonymous
        traffic shows up under tenant -1."""
        out: dict = {}
        for v in self.instances:
            for tenant, _cls, toks in v.tenant_tokens:
                out[tenant] = out.get(tenant, 0) + int(toks)
        return dict(sorted(out.items()))

    def class_resident_tokens(self) -> dict:
        """Same accounting keyed by SLO class (sorted)."""
        out: dict = {}
        for v in self.instances:
            for _tenant, cls, toks in v.tenant_tokens:
                out[cls] = out.get(cls, 0) + int(toks)
        return dict(sorted(out.items()))
