"""Hardware models for heterogeneous serving instances.

Copy of ``repro/cluster/hardware.py`` (numpy and plain Python),
kept in the port so that it imports nothing of ``repro``.  Its imports
and references name ``repro_torch`` where the reference names
``repro``; any other line that differs carries a comment saying so.
Everything else, float expressions and iteration orders included, is
as written there.

Analytic iteration-latency model (roofline style): an engine iteration is
max(compute, memory) + fixed overhead.  This reproduces the Fig. 1 shape —
per-iteration latency nearly flat in batch while memory-bound (weights
dominate reads), then rising once compute-bound — and its cross-GPU
ordering (V100 > A40 > A800 > H800).

The paper's four testbed GPUs are included for figure reproduction, plus
TPU entries (the deployment target of this framework).  Per-arch serving
rates for TPU slices can instead be derived from dry-run roofline terms
(see benchmarks/roofline.py), which is how the large-scale simulation is
wired to physics.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    tflops: float          # dense bf16/fp16 peak, TFLOP/s
    hbm_gbps: float        # HBM bandwidth, GB/s
    mem_gb: float          # usable HBM
    tp: int = 1            # tensor-parallel degree of the instance
    mfu: float = 0.45      # achievable fraction of peak flops
    mbu: float = 0.70      # achievable fraction of peak bandwidth
    overhead_ms: float = 4.0   # per-iteration fixed cost (kernel launch etc.)
    max_seqs: int = 64     # engine admission cap (vLLM max_num_seqs-style);
                           # queues form beyond it, giving the proxy a live
                           # backpressure signal
    cost_per_hour: float = 4.0   # on-demand $/hr for the whole instance
    warmup_s: float = 40.0       # provision + weight-load latency before
                                 # the instance can serve (elastic pool)
    # -- spot/preemptible capacity -------------------------------------
    is_spot: bool = False        # preemptible instance class
    evictions_per_hour: float = 0.0  # Poisson rate of eviction notices
                                     # while the instance is up
    grace_s: float = 0.0         # notice -> kill window (evacuation time)
    # -- placement ------------------------------------------------------
    region: str = ""             # geographic region ("" = unplaced; an
                                 # Instance may override per-replica).
                                 # Pairs of regions resolve to a network
                                 # tier via migration.Topology.

    @property
    def eff_flops(self) -> float:
        scale = 1.0 if self.tp == 1 else 0.85  # TP comm efficiency
        return self.tflops * 1e12 * self.mfu * self.tp * scale

    @property
    def eff_bw(self) -> float:
        return self.hbm_gbps * 1e9 * self.mbu * self.tp


# Published dense fp16/bf16 peaks (no sparsity).  $/hr approximates
# on-demand cloud list prices for the full instance (V100 runs TP=2, so
# two cards); warmup covers VM provision + container pull + weight load.
GPUS = {
    "V100": HardwareSpec("V100", 125.0, 900.0, 32.0, tp=2,    # paper TP=2
                         cost_per_hour=4.9, warmup_s=55.0),
    "A40": HardwareSpec("A40", 149.7, 696.0, 48.0,
                        cost_per_hour=1.3, warmup_s=45.0),
    "A800": HardwareSpec("A800", 312.0, 2039.0, 80.0,
                         cost_per_hour=5.2, warmup_s=40.0),
    "H800": HardwareSpec("H800", 989.0, 3350.0, 80.0,
                         cost_per_hour=12.1, warmup_s=35.0),
    # differs: the card the port measures on (H100 SXM5, published dense
    # bf16 and HBM3 figures: the H800's silicon); $/hr and warmup are the
    # H800's, not a price of their own
    "H100": HardwareSpec("H100", 989.0, 3350.0, 80.0,
                         cost_per_hour=12.1, warmup_s=35.0),
    "v5e": HardwareSpec("v5e", 197.0, 819.0, 16.0, overhead_ms=2.0,
                        cost_per_hour=1.2, warmup_s=30.0),
    "v5p": HardwareSpec("v5p", 459.0, 2765.0, 95.0, overhead_ms=2.0,
                        cost_per_hour=4.2, warmup_s=30.0),
    "v4": HardwareSpec("v4", 275.0, 1228.0, 32.0, overhead_ms=2.0,
                       cost_per_hour=3.2, warmup_s=30.0),
}

PAPER_CLUSTER = ("H800", "A800", "A40", "V100")

# Spot capacity trades a deep discount for eviction risk: the provider
# may reclaim the instance at any time, giving only a short grace notice.
# Discount and notice window approximate public cloud spot terms (60-70%
# off, 30 s - 2 min notice); the eviction rate is workload-visible churn,
# not a provider SLA, so it is a knob.
SPOT_DISCOUNT = 0.35         # spot $/hr as a fraction of on-demand
SPOT_GRACE_S = 30.0          # provider notice -> kill window
SPOT_EVICTIONS_PER_HOUR = 12.0


def spot_variant(hw: HardwareSpec,
                 discount: float = SPOT_DISCOUNT,
                 evictions_per_hour: float = SPOT_EVICTIONS_PER_HOUR,
                 grace_s: float = SPOT_GRACE_S) -> HardwareSpec:
    """The preemptible twin of an on-demand catalog entry: identical
    silicon, discounted $/hr, plus an eviction process."""
    return dataclasses.replace(
        hw, name=f"{hw.name}-spot",
        cost_per_hour=hw.cost_per_hour * discount,
        is_spot=True, evictions_per_hour=evictions_per_hour,
        grace_s=grace_s)


SPOT_GPUS = {f"{n}-spot": spot_variant(hw) for n, hw in GPUS.items()}


def catalog(name: str) -> HardwareSpec:
    """Resolve a catalog name — on-demand ("A800") or spot ("A800-spot")."""
    if name in GPUS:
        return GPUS[name]
    if name in SPOT_GPUS:
        return SPOT_GPUS[name]
    raise KeyError(name)


@dataclasses.dataclass(frozen=True)
class ModelFootprint:
    """What the hardware model needs to know about a served model."""
    name: str
    n_params: float            # total params
    n_active: float            # active per token (MoE-aware)
    kv_bytes_per_token: float  # KV-cache bytes per token (all layers)
    dtype_bytes: int = 2

    @classmethod
    def from_config(cls, cfg: ModelConfig):
        kv = 0.0
        for blk in cfg.layer_list():
            if blk.mixer in ("full", "window"):
                kv += 2 * cfg.num_kv_heads * cfg.head_dim * 2
            elif blk.mixer == "mla":
                kv += (cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim) * 2
            # mamba states are O(1), not per token
        return cls(cfg.name, cfg.param_count(),
                   cfg.param_count(active_only=True), kv)


# The paper's backends, with param counts from our configs (computed lazily
# to avoid importing model code here).
def footprint(model_name: str) -> ModelFootprint:
    from repro_torch.configs import get_config
    return ModelFootprint.from_config(get_config(model_name))


def decode_iteration_time(hw: HardwareSpec, fp: ModelFootprint,
                          batch: int, avg_ctx: float,
                          profile=None) -> float:
    """Seconds for one decode iteration of ``batch`` requests whose mean
    context length is ``avg_ctx``.

    When a measured :class:`~repro_torch.bench.profile.LatencyProfile` is
    supplied, it answers instead of the analytic roofline (bilinear over
    the measured grid, calibrated analytic beyond it) — the catalog
    constants become the fallback, not the truth."""
    if profile is not None:
        return profile.decode_time(batch, avg_ctx)
    if batch <= 0:
        return 0.0
    flops = 2.0 * fp.n_active * batch
    compute = flops / hw.eff_flops
    weight_bytes = fp.n_params * fp.dtype_bytes
    kv_read = batch * avg_ctx * fp.kv_bytes_per_token
    memory = (weight_bytes + kv_read) / hw.eff_bw
    return max(compute, memory) + hw.overhead_ms / 1e3


def prefill_time(hw: HardwareSpec, fp: ModelFootprint, n_tokens: int,
                 cached_prefix: int = 0, profile=None) -> float:
    """Seconds to prefill ``n_tokens`` (minus reusable cached prefix).
    A measured profile, when supplied, overrides the analytic model."""
    if profile is not None:
        return profile.prefill_time(n_tokens, cached_prefix)
    n = max(n_tokens - cached_prefix, 0)
    if n == 0:
        return hw.overhead_ms / 1e3
    flops = 2.0 * fp.n_active * n
    compute = flops / hw.eff_flops
    weight_bytes = fp.n_params * fp.dtype_bytes
    memory = weight_bytes / hw.eff_bw
    return max(compute, memory) + hw.overhead_ms / 1e3


KV_FRACTION = 0.9   # HBM derate: fragmentation, activations, CUDA graphs


def kv_capacity_bytes(hw: HardwareSpec, fp: ModelFootprint) -> float:
    """Usable KV-cache bytes on an instance: total HBM across the TP
    group minus ONE full copy of the weights (sharded over the group),
    derated by ``KV_FRACTION``.  The single source of truth for KV
    capacity — ``max_batch`` and ``Instance.mem_used_frac`` both pin to
    it (they used to account weight bytes vs ``tp`` inconsistently)."""
    total = hw.mem_gb * 1e9 * hw.tp
    weights = fp.n_params * fp.dtype_bytes
    return max((total - weights) * KV_FRACTION, 1.0)


def max_batch(hw: HardwareSpec, fp: ModelFootprint,
              avg_total_len: float) -> int:
    """Memory-capacity bound on concurrent requests (Eq. 1's constraint)."""
    per_req = max(avg_total_len, 1.0) * fp.kv_bytes_per_token
    return max(int(kv_capacity_bytes(hw, fp) / per_req), 1)
