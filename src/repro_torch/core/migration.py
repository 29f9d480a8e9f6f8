"""Request-migration cost models (paper Sec. 3.4 + Fig. 9).

Copy of ``repro/core/migration.py`` (numpy and plain Python),
kept in the port so that it imports nothing of ``repro``.  Its imports
and references name ``repro_torch`` where the reference names
``repro``; any other line that differs carries a comment saying so.
Everything else, float expressions and iteration orders included, is
as written there.

GoodServe migrates by shipping *token IDs* and re-prefilling at the
target; the rejected alternative ships the KV cache.  Both are modeled so
Fig. 9's trade-off is reproducible, for the paper's 10 GbE testbed and
for TPU-fleet links (DCN) — the conclusion is link-speed dependent, which
is why we carry both (DESIGN.md §3).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.cluster import hardware as hwlib

TOKEN_ID_BYTES = 4


@dataclasses.dataclass(frozen=True)
class NetworkSpec:
    name: str
    bandwidth_gbps: float      # usable, in gigaBITS/s
    rtt_ms: float = 0.5

    @property
    def bytes_per_s(self) -> float:
        return self.bandwidth_gbps * 1e9 / 8.0


ETHERNET_10G = NetworkSpec("10GbE", 10.0, 0.5)       # the paper's testbed
TPU_DCN = NetworkSpec("tpu-dcn", 100.0, 0.3)         # inter-slice DCN
WAN = NetworkSpec("wan", 2.0, 30.0)                  # inter-region backbone


@dataclasses.dataclass(frozen=True)
class Topology:
    """Network tiers for a geo-distributed pool (Helix-style).

    Any instance pair resolves to exactly one :class:`NetworkSpec`:
    ``intra`` when both sit in the same region, ``inter`` otherwise —
    unless ``links`` names the specific region pair (unordered), which
    lets a pool model, e.g., a fat pipe between two nearby metros next
    to a default WAN tier.  A flat single-tier pool is the degenerate
    ``Topology(intra=net, inter=net)`` (see :func:`flat_topology`),
    which prices every pair identically — byte-identical to the old
    single-``NetworkSpec`` cluster.
    """
    intra: NetworkSpec = ETHERNET_10G
    inter: NetworkSpec = WAN
    links: Tuple[Tuple[str, str, NetworkSpec], ...] = ()

    def tier(self, region_a: str, region_b: str) -> NetworkSpec:
        if region_a == region_b:
            return self.intra
        key = frozenset((region_a, region_b))
        for a, b, net in self.links:
            if frozenset((a, b)) == key:
                return net
        return self.inter


def flat_topology(net: NetworkSpec) -> Topology:
    """The single-tier topology equivalent to a bare ``NetworkSpec``."""
    return Topology(intra=net, inter=net)

# engine-side coordination per migration: pause/drain the request at the
# source, serialize state, RPC to the target scheduler, resume.  Applies
# to both transfer modes; measured vLLM-style KV extraction additionally
# runs well below line rate (layer-by-layer gather + serialization).
FIXED_OVERHEAD_S = 0.1
KV_EXTRACT_EFFICIENCY = 0.6


def token_id_transfer_latency(net: NetworkSpec, context_len: int) -> float:
    """State-transfer latency of token-ID migration (Fig. 9's metric):
    the re-prefill at the target is the separate 'small prefill overhead'
    the paper trades for it (Sec. 3.4)."""
    xfer = context_len * TOKEN_ID_BYTES / net.bytes_per_s
    return FIXED_OVERHEAD_S + net.rtt_ms / 1e3 + xfer


def kv_transfer_latency(net: NetworkSpec, fp, context_len: int) -> float:
    bytes_ = context_len * fp.kv_bytes_per_token
    return (FIXED_OVERHEAD_S + net.rtt_ms / 1e3
            + bytes_ / (net.bytes_per_s * KV_EXTRACT_EFFICIENCY))


def token_id_migration_latency(net: NetworkSpec, hw_dst, fp,
                               context_len: int,
                               prefix_hit: int = 0) -> float:
    """End-to-end: transfer token IDs + re-prefill at the target (this is
    what the simulator charges a migrated request)."""
    refill = hwlib.prefill_time(hw_dst, fp, context_len, prefix_hit)
    return token_id_transfer_latency(net, context_len) + refill


def kv_cache_migration_latency(net: NetworkSpec, fp,
                               context_len: int) -> float:
    """End-to-end KV-cache migration; no re-prefill needed."""
    return kv_transfer_latency(net, fp, context_len)


def plan_evacuation(net: NetworkSpec, hw_dst, fp, context_len: int,
                    grace_remaining_s: float,
                    prefix_hit: int = 0) -> str:
    """Escape mode for a running request on an instance that received an
    eviction notice: its KV state must leave the machine within the
    grace window or be lost.

    Token-ID always escapes (the payload is a few KB), but re-prefilling
    at the target costs compute the crossover model prices.  Ship the KV
    cache iff (a) the transfer itself clears the dying machine before
    the kill — a half-shipped KV cache is worthless — and (b) it is the
    cheaper end-to-end path for this context on this link.  Queued work
    holds no KV state and always escapes as token IDs."""
    kv_exit = kv_transfer_latency(net, fp, context_len)
    if kv_exit > max(grace_remaining_s, 0.0):
        return "token_id"
    tok_e2e = token_id_migration_latency(net, hw_dst, fp, context_len,
                                         prefix_hit)
    return "kv" if kv_exit <= tok_e2e else "token_id"


def transfer_crossover_context(net: NetworkSpec, hw_dst, fp,
                               hi: int = 1 << 18) -> Optional[int]:
    """Smallest context length at which token-ID migration (transfer +
    re-prefill at the target) becomes cheaper end-to-end than shipping
    the KV cache.  Below it the KV path wins (the re-prefill's fixed
    weight-read floor dominates); above it the per-token KV payload
    does.  Returns None if token-ID never wins below ``hi`` — which is
    the fast-link regime where the paper's conclusion flips."""
    def gap(ctx: int) -> float:
        return (token_id_migration_latency(net, hw_dst, fp, ctx)
                - kv_cache_migration_latency(net, fp, ctx))
    if gap(hi) > 0:
        return None
    if gap(1) <= 0:
        return 1
    lo = 1
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if gap(mid) > 0:
            lo = mid
        else:
            hi = mid
    return hi


def plan_handoff(net: NetworkSpec, hw_dst, fp, context_len: int,
                 prefix_hit: int = 0) -> str:
    """Transfer mode for a prefill→decode handoff: ship the KV cache iff
    it beats token IDs + re-prefill-at-the-target end-to-end on this
    link.  Unlike :func:`plan_evacuation` there is no grace deadline —
    the source is healthy — so this is the pure crossover decision,
    resolved per network tier (a mode that wins intra-region can lose
    across the WAN, where the per-token KV payload dominates)."""
    kv = kv_cache_migration_latency(net, fp, context_len)
    tok = token_id_migration_latency(net, hw_dst, fp, context_len,
                                     prefix_hit)
    return "kv" if kv <= tok else "token_id"


def handoff_latency(net: NetworkSpec, hw_dst, fp, context_len: int,
                    mode: str, prefix_hit: int = 0) -> float:
    """End-to-end cost of a handoff in the given mode — what a
    region-aware router deducts from a request's slack before choosing
    a decode target."""
    if mode == "kv":
        return kv_cache_migration_latency(net, fp, context_len)
    return token_id_migration_latency(net, hw_dst, fp, context_len,
                                      prefix_hit)
