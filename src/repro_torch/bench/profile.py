"""Measured latency profiles: the calibration path from the engine layer
into the serving loop.

Port of ``repro/bench/profile.py``.  ``LatencyProfile``,
``analytic_profile`` and ``_analytic_terms`` are copies (JSON included, so
a profile written here loads in the reference and back); the port adds the
``measured-cuda`` provenance, the counterpart of ``measured-tpu``.
:func:`measure_engine_profile` times the port's ``InferenceEngine``.  The
reference's ``paged_kernel_microbench`` times its Pallas kernel's
``pages_per_tile`` tile against one page per step; the port's paged kernel
picks its split from the shapes and has no such tile, so it has no
counterpart here (``chip_smoke.py`` times that kernel against its bound).

A :class:`LatencyProfile` is a versioned, provenance-tagged JSON artifact
holding two measured grids for one (hardware, model) pair:

  * per-iteration decode latency over a (batch x context) grid, and
  * prefill latency over a chunk-size grid,

plus the analytic roofline terms of the hardware that produced it.  The
artifact is the ONLY thing that crosses the layer boundary: the engine
measures, the simulator and estimator consume.

Consumption contract:

  * inside the measured grid, queries bilinearly interpolate (exact at
    grid nodes, monotone between monotone nodes);
  * beyond the grid, the analytic roofline model extrapolates, scaled by
    the measured/analytic ratio at the nearest grid corner — so a
    hardware entry whose silicon runs 1.3x slower than catalog keeps
    that 1.3x outside the grid too;
  * ``priors()`` turns a profile into an (q, p, d) capability prior so
    routers rank instances correctly before any observation arrives.

Profiles are plain data: evaluation never reads a clock, so simulations
with profiles attached stay byte-identically replayable.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

from repro_torch.cluster import hardware as hwlib
from repro_torch.core.estimator import InstanceEstimate

SCHEMA_VERSION = 1
# differs: "measured-cuda", the port's engine timed on a CUDA card
PROVENANCES = ("measured-tpu", "measured-cpu", "interpret", "analytic",
               "measured-cuda")


def _interp1(xs: Sequence[float], ys: Sequence[float], x: float) -> float:
    """Piecewise-linear interpolation on an ascending grid (clamped)."""
    if x <= xs[0]:
        return float(ys[0])
    if x >= xs[-1]:
        return float(ys[-1])
    i = bisect.bisect_right(xs, x) - 1
    x0, x1 = xs[i], xs[i + 1]
    w = (x - x0) / (x1 - x0)
    return float(ys[i] * (1.0 - w) + ys[i + 1] * w)


@dataclasses.dataclass(frozen=True)
class LatencyProfile:
    """One (hardware, model) calibration artifact.  Grids are tuples so
    the profile is hashable/immutable; seconds everywhere."""
    hardware: str
    model: str
    provenance: str
    decode_batches: Tuple[float, ...]        # ascending
    decode_ctxs: Tuple[float, ...]           # ascending
    decode_s: Tuple[Tuple[float, ...], ...]  # [batch][ctx] iteration time
    prefill_tokens: Tuple[float, ...]        # ascending chunk sizes
    prefill_s: Tuple[float, ...]             # prefill wall time per chunk
    overhead_s: float                        # fixed per-iteration cost
    queue_wait_prior_s: float = 0.0
    # roofline terms of the hardware that produced the grids — the
    # extrapolation model beyond them (see decode_time/prefill_time)
    analytic: Mapping[str, float] = dataclasses.field(default_factory=dict)
    meta: Mapping[str, object] = dataclasses.field(default_factory=dict)
    schema_version: int = SCHEMA_VERSION

    def __post_init__(self):
        if self.provenance not in PROVENANCES:
            raise ValueError(f"unknown provenance {self.provenance!r}; "
                             f"expected one of {PROVENANCES}")
        if self.schema_version != SCHEMA_VERSION:
            raise ValueError(f"profile schema v{self.schema_version} != "
                             f"supported v{SCHEMA_VERSION}")
        for name, xs in (("decode_batches", self.decode_batches),
                         ("decode_ctxs", self.decode_ctxs),
                         ("prefill_tokens", self.prefill_tokens)):
            if not xs or list(xs) != sorted(xs):
                raise ValueError(f"{name} must be a non-empty ascending "
                                 f"grid, got {xs!r}")
        if len(self.decode_s) != len(self.decode_batches) or any(
                len(row) != len(self.decode_ctxs) for row in self.decode_s):
            raise ValueError("decode_s shape must be "
                             "[len(decode_batches)][len(decode_ctxs)]")
        if len(self.prefill_s) != len(self.prefill_tokens):
            raise ValueError("prefill_s length must match prefill_tokens")

    # -- analytic extrapolation terms -----------------------------------

    def _analytic_decode(self, batch: float, ctx: float) -> float:
        a = self.analytic
        compute = 2.0 * a["n_active"] * batch / a["eff_flops"]
        memory = (a["weight_bytes"]
                  + batch * ctx * a["kv_bytes_per_token"]) / a["eff_bw"]
        return max(compute, memory) + self.overhead_s

    def _analytic_prefill(self, n: float) -> float:
        a = self.analytic
        compute = 2.0 * a["n_active"] * n / a["eff_flops"]
        memory = a["weight_bytes"] / a["eff_bw"]
        return max(compute, memory) + self.overhead_s

    # -- queries ---------------------------------------------------------

    def decode_time(self, batch: int, avg_ctx: float) -> float:
        """Seconds for one decode iteration: bilinear inside the measured
        grid, ratio-calibrated analytic roofline beyond it."""
        if batch <= 0:
            return 0.0
        bs, cs = self.decode_batches, self.decode_ctxs
        b = float(batch)
        c = float(avg_ctx)
        bc = min(max(b, bs[0]), bs[-1])
        cc = min(max(c, cs[0]), cs[-1])
        rows = [_interp1(cs, row, cc) for row in self.decode_s]
        measured = _interp1(bs, rows, bc)
        if bc == b and cc == c:
            return measured
        if not self.analytic:
            return measured                     # clamp when no roofline
        ref = self._analytic_decode(bc, cc)
        scale = measured / ref if ref > 0 else 1.0
        return self._analytic_decode(b, c) * scale

    def prefill_time(self, n_tokens: int, cached_prefix: int = 0) -> float:
        """Seconds to prefill ``n_tokens`` (minus reusable cached prefix)."""
        n = float(max(n_tokens - cached_prefix, 0))
        if n == 0:
            return self.overhead_s
        xs = self.prefill_tokens
        nc = min(max(n, xs[0]), xs[-1])
        measured = _interp1(xs, self.prefill_s, nc)
        if nc == n:
            return measured
        if not self.analytic:
            return measured
        ref = self._analytic_prefill(nc)
        scale = measured / ref if ref > 0 else 1.0
        return self._analytic_prefill(n) * scale

    def chunk_time(self, n_tokens: int) -> float:
        """Marginal cost of folding an ``n_tokens`` prefill chunk into an
        iteration that already pays the fixed overhead (the simulator's
        hybrid decode+chunk step)."""
        if n_tokens <= 0:
            return 0.0
        return max(self.prefill_time(n_tokens) - self.overhead_s, 0.0)

    def priors(self, n_obs: int = 3) -> InstanceEstimate:
        """Profile-derived (q, p, d) capability prior.  ``n_obs`` defaults
        past ``GoodServeRouter.min_obs`` so a profiled instance is ranked
        from its prior immediately instead of round-robin explored."""
        big = self.prefill_tokens[-1]
        p = max((self.prefill_time(int(big)) - self.overhead_s) / big, 1e-9)
        b = self.decode_batches[len(self.decode_batches) // 2]
        c = self.decode_ctxs[len(self.decode_ctxs) // 2]
        d = self.decode_time(int(b), c)
        return InstanceEstimate(q=self.queue_wait_prior_s, p=p, d=d,
                                n_obs=n_obs)

    # -- (de)serialization ----------------------------------------------

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["analytic"] = dict(self.analytic)
        d["meta"] = dict(self.meta)
        return d

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
            f.write("\n")

    @classmethod
    def from_json(cls, d: Mapping) -> "LatencyProfile":
        return cls(
            hardware=d["hardware"], model=d["model"],
            provenance=d["provenance"],
            decode_batches=tuple(d["decode_batches"]),
            decode_ctxs=tuple(d["decode_ctxs"]),
            decode_s=tuple(tuple(row) for row in d["decode_s"]),
            prefill_tokens=tuple(d["prefill_tokens"]),
            prefill_s=tuple(d["prefill_s"]),
            overhead_s=float(d["overhead_s"]),
            queue_wait_prior_s=float(d.get("queue_wait_prior_s", 0.0)),
            analytic=dict(d.get("analytic", {})),
            meta=dict(d.get("meta", {})),
            schema_version=int(d.get("schema_version", SCHEMA_VERSION)))

    @classmethod
    def load(cls, path) -> "LatencyProfile":
        with open(path) as f:
            return cls.from_json(json.load(f))


def _analytic_terms(hw: hwlib.HardwareSpec,
                    fp: hwlib.ModelFootprint) -> Dict[str, float]:
    return {"n_active": fp.n_active, "eff_flops": hw.eff_flops,
            "eff_bw": hw.eff_bw,
            "weight_bytes": fp.n_params * fp.dtype_bytes,
            "kv_bytes_per_token": fp.kv_bytes_per_token}


DEFAULT_BATCHES = (1, 2, 4, 8, 16, 32)
DEFAULT_CTXS = (128.0, 512.0, 1024.0, 2048.0, 4096.0)
DEFAULT_CHUNKS = (64, 128, 256, 512, 1024, 2048)


def analytic_profile(hw: hwlib.HardwareSpec, fp: hwlib.ModelFootprint,
                     batches: Sequence[int] = DEFAULT_BATCHES,
                     ctxs: Sequence[float] = DEFAULT_CTXS,
                     chunks: Sequence[int] = DEFAULT_CHUNKS,
                     queue_wait_prior_s: float = 0.0,
                     meta: Optional[Mapping] = None) -> LatencyProfile:
    """The CPU/CI fallback: grids filled from the roofline model itself.
    Exact at every node by construction, so it reproduces the analytic
    path bit-for-bit — the artifact format and plumbing are exercised
    without hardware."""
    decode = tuple(tuple(hwlib.decode_iteration_time(hw, fp, b, c)
                         for c in ctxs) for b in batches)
    pre = tuple(hwlib.prefill_time(hw, fp, n) for n in chunks)
    return LatencyProfile(
        hardware=hw.name, model=fp.name, provenance="analytic",
        decode_batches=tuple(float(b) for b in batches),
        decode_ctxs=tuple(float(c) for c in ctxs),
        decode_s=decode,
        prefill_tokens=tuple(float(n) for n in chunks), prefill_s=pre,
        overhead_s=hw.overhead_ms / 1e3,
        queue_wait_prior_s=queue_wait_prior_s,
        analytic=_analytic_terms(hw, fp), meta=dict(meta or {}))




PREFILL_REPEATS = 5


def measure_engine_profile(cfg, hw: hwlib.HardwareSpec,
                           batches: Sequence[int] = (1, 2),
                           ctxs: Sequence[int] = (16, 32),
                           chunks: Sequence[int] = (8, 16, 32),
                           decode_iters: int = 4,
                           seed: int = 0,
                           prefill_chunk: Optional[int] = None,
                           meta: Optional[Mapping] = None, *,
                           dtype=None,
                           max_len: Optional[int] = None,
                           device="cuda") -> LatencyProfile:
    """Measure the port's REAL engine: prefill time per chunk size and
    decode iteration time per (batch, context), read back through
    ``InferenceEngine.drain_events()``, which synchronises the device
    before each clock read.  Provenance is "measured-cuda" on a CUDA
    device and "measured-cpu" on the CPU (plumbing smoke only, never a
    capability claim).

    Beyond the reference's arguments: ``dtype`` of the one weight set that
    every engine of the grid shares (drawn from ``seed``; default
    float32), ``max_len`` (default: the reference's, the largest grid
    length plus ``decode_iters + 4``) and ``device``.  Where the reference
    times one prompt per prefill entry, each entry here is the median of
    ``PREFILL_REPEATS`` prompts: the host's jitter moves a single eager
    prefill by tens of percent.  The whole grid runs once untimed before
    the timed pass, so that no grid point pays first-call costs (library
    heuristics, kernel loads) that the reference's dropped slowest decode
    iteration would not cover; ``meta["warmup"]`` records it.  Each engine
    is dropped, and with it its KV pages, before the next is built.

    On the card every engine replays its decode step from a CUDA graph
    captured when it is built; ``meta["decode_graph"]`` says so and holds
    the spread of the capture seconds over the timed pass's engines.
    ``meta`` also records what each entry rests on:
    ``decode_spread_s[i][j]`` and ``prefill_spread_s[j]`` hold the count,
    minimum, quartiles and maximum of the timed samples; and
    ``analytic_points`` lists the ``[batch, ctx]`` points that had no
    decode step at full batch and so, as in the reference, hold the
    analytic roofline instead of a measurement (a consumer that needs a
    measured grid checks that it is empty)."""
    import time

    import numpy as np
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.engine.engine import EngineRequest, InferenceEngine
    from repro_torch.models.model import init_params

    dev = resolve_device(device)
    provenance = "measured-cuda" if dev.type == "cuda" else "measured-cpu"
    rng = np.random.default_rng(seed)
    params = init_params(cfg, seed=seed, dtype=dtype or torch.float32,
                         device=dev)
    fp = hwlib.ModelFootprint.from_config(cfg)
    if max_len is None:
        max_len = max(max(chunks), max(ctxs)) + decode_iters + 4

    def prompt(n):
        return [int(x) for x in rng.integers(1, cfg.vocab_size, size=n)]

    captures = []       # capture seconds of each engine of the pass

    def engine(b):
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        eng = InferenceEngine(cfg, params, max_batch=b, max_len=max_len,
                              seed=seed, prefill_chunk=prefill_chunk,
                              device=dev)
        if eng.capture_s is not None:
            captures.append(eng.capture_s)
        return eng

    def spread(xs):
        if not xs:
            return {"n": 0}
        q1, q3 = np.percentile(xs, [25, 75])
        return {"n": len(xs), "min": min(xs), "p25": float(q1),
                "p75": float(q3), "max": max(xs)}

    def grid():
        captures.clear()
        # -- prefill grid: one request per chunk size, timed by the engine;
        # the median of PREFILL_REPEATS such requests
        pre_s, pre_spread = [], []
        for n in chunks:
            eng = engine(1)
            runs = []
            for rid in range(PREFILL_REPEATS):
                eng.submit(EngineRequest(rid=rid, tokens=prompt(n),
                                         prompt_len=n, max_new_tokens=1))
                eng.run_until_drained()
                runs.append(float(sum(dt for kind, ntok, dt
                                      in eng.drain_events()
                                      if kind == "prefill")))
            pre_s.append(sorted(runs)[len(runs) // 2])
            pre_spread.append(spread(runs))
            del eng
        # -- decode grid: b requests at context c, median steady iteration
        decode_s, dec_spread, analytic_points = [], [], []
        for b in batches:
            row, row_spread = [], []
            for c in ctxs:
                eng = engine(b)
                for rid in range(b):
                    eng.submit(EngineRequest(
                        rid=rid, tokens=prompt(c), prompt_len=c,
                        max_new_tokens=decode_iters + 1))
                eng.run_until_drained()
                dts = sorted(dt for kind, n_active, dt in eng.drain_events()
                             if kind == "decode" and n_active == b)
                del eng
                row_spread.append(spread(dts))
                if not dts:
                    analytic_points.append([b, c])
                # median over steady iterations; drop the slowest
                dts = dts[:-1] if len(dts) > 1 else dts
                row.append(float(dts[len(dts) // 2]) if dts else
                           hwlib.decode_iteration_time(hw, fp, b, c))
            decode_s.append(tuple(row))
            dec_spread.append(row_spread)
        return pre_s, decode_s, {
            "decode_spread_s": dec_spread, "prefill_spread_s": pre_spread,
            "analytic_points": analytic_points,
            "decode_graph": {"replayed": dev.type == "cuda",
                             "capture_s": spread(captures)}}

    m = {"backend": dev.type, "decode_iters": decode_iters,
         "prefill_repeats": PREFILL_REPEATS, "seed": seed,
         "dtype": str(params.dtype).replace("torch.", ""),
         "max_len": max_len,
         "prefill_chunk": prefill_chunk, "torch": torch.__version__}
    if dev.type == "cuda":
        m.update(device_name=torch.cuda.get_device_name(dev),
                 cuda=torch.version.cuda)
    t0 = time.perf_counter()
    grid()
    m["warmup"] = {"passes": 1, "what": "every grid point once, untimed",
                   "seconds": time.perf_counter() - t0}
    pre_s, decode_s, m_grid = grid()
    m.update(m_grid)
    m.update(meta or {})
    return LatencyProfile(
        hardware=hw.name, model=cfg.name, provenance=provenance,
        decode_batches=tuple(float(b) for b in batches),
        decode_ctxs=tuple(float(c) for c in ctxs),
        decode_s=tuple(decode_s),
        prefill_tokens=tuple(float(n) for n in chunks),
        prefill_s=tuple(pre_s),
        overhead_s=hw.overhead_ms / 1e3,
        analytic=_analytic_terms(hw, fp), meta=m)
