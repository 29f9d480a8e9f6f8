"""Frozen copy of the paper's agentic traffic generator, numpy only.

Copied from the port's ``repro_torch/cluster/workload.py`` (itself a copy
of the paper's generator) and its ``cluster/hardware.py``: the three task
families of ``FAMILIES``, ``sample_request`` (the prompt words are drawn
and dropped, so the random stream is the generator's own), the
Mooncake-like arrivals and ``solo_latency`` on the analytic A800.  It is
frozen here so that a later change to the program's generator cannot move
the benchmark's traffic; ``portbench/tests`` holds it to recorded numbers.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class FamilySpec:
    name: str
    in_mean: float
    in_std: float
    out_mu: float             # lognormal parameters of the base output
    out_sigma: float
    complexity_gain: float    # extra output tokens per complexity marker
    bimodal_frac: float = 0.0  # share of "long tail" episodes
    bimodal_mult: float = 4.0


# BIRD text-to-SQL, LiveCodeBench and SWE-bench stand-ins
FAMILIES = {
    "sql": FamilySpec("sql", 300, 90, np.log(70), 0.40, 4.0),
    "code": FamilySpec("code", 450, 130, np.log(260), 0.50, 10.0),
    "swe": FamilySpec("swe", 900, 250, np.log(120), 0.45, 8.0,
                      bimodal_frac=0.2, bimodal_mult=3.0),
}
FAMILY_ORDER = ("sql", "code", "swe")

# the prompt's word pools; only their sizes matter to the random stream
_FAMILY_POOL = 21
_SHARED_POOL = 24


@dataclasses.dataclass
class Draw:
    """One request's sizes: family, prompt and output lengths."""
    family: str
    input_len: int
    output_len: int


def _prompt_draws(rng) -> None:
    """The generator's prompt words: drawn (as ``_make_prompt`` draws
    them) and dropped; the benchmark sends token ids of its own."""
    n_words = max(int(rng.normal(40, 10)), 12)
    for _ in range(n_words):
        pool = _FAMILY_POOL if rng.random() < 0.45 else _SHARED_POOL
        rng.integers(pool)


def sample_request(rng, family: str | None = None) -> Draw:
    name = family or FAMILY_ORDER[rng.integers(3)]
    fam = FAMILIES[name]
    complexity = int(rng.integers(0, 8))
    input_len = max(int(rng.normal(fam.in_mean, fam.in_std)), 32)
    base = rng.lognormal(fam.out_mu, fam.out_sigma)
    out = base + fam.complexity_gain * complexity * rng.uniform(0.6, 1.4)
    if fam.bimodal_frac and rng.random() < fam.bimodal_frac:
        out *= fam.bimodal_mult
    output_len = int(np.clip(out, 8, 8192))
    _prompt_draws(rng)
    rng.integers(0, 32)          # the generator's prefix group
    return Draw(name, input_len, output_len)


def mooncake_like_arrivals(rng, n: int, rps: float, cv: float = 1.3,
                           burst_period: float = 60.0,
                           swing: float = 0.35) -> np.ndarray:
    """Gamma interarrivals (coefficient of variation ``cv``) at mean rate
    ``rps``, modulated by a sinusoidal load swing of ``swing`` over
    ``burst_period`` seconds."""
    shape = 1.0 / (cv * cv)
    inter = rng.gamma(shape, 1.0 / (rps * shape), size=n)
    t = np.cumsum(inter)
    mod = 1.0 + swing * np.sin(2 * np.pi * t / burst_period)
    return np.cumsum(inter / mod)


@dataclasses.dataclass(frozen=True)
class Gpu:
    """A catalog GPU of the analytic latency model."""
    tflops: float
    hbm_gbps: float
    mfu: float = 0.45
    mbu: float = 0.70
    overhead_ms: float = 4.0

    @property
    def eff_flops(self) -> float:
        return self.tflops * 1e12 * self.mfu

    @property
    def eff_bw(self) -> float:
        return self.hbm_gbps * 1e9 * self.mbu


A800 = Gpu(312.0, 2039.0)


@dataclasses.dataclass(frozen=True)
class Footprint:
    """What the analytic model needs of a served model."""
    n_params: float            # all parameters
    n_active: float            # parameters a token reads (MoE: top-k)
    kv_bytes_per_token: float
    dtype_bytes: int = 2


def decode_iteration_time(hw: Gpu, fp: Footprint, batch: int,
                          avg_ctx: float) -> float:
    flops = 2.0 * fp.n_active * batch
    compute = flops / hw.eff_flops
    memory = (fp.n_params * fp.dtype_bytes
              + batch * avg_ctx * fp.kv_bytes_per_token) / hw.eff_bw
    return max(compute, memory) + hw.overhead_ms / 1e3


def prefill_time(hw: Gpu, fp: Footprint, n_tokens: int) -> float:
    compute = 2.0 * fp.n_active * n_tokens / hw.eff_flops
    memory = fp.n_params * fp.dtype_bytes / hw.eff_bw
    return max(compute, memory) + hw.overhead_ms / 1e3


def solo_latency(hw: Gpu, fp: Footprint, input_len: int,
                 output_len: int) -> float:
    """End-to-end seconds of a request alone on ``hw``: its prefill, then
    one token at a time at batch 1."""
    t = prefill_time(hw, fp, input_len)
    return t + output_len * decode_iteration_time(
        hw, fp, 1, input_len + output_len / 2)
