"""Serving launcher: the GoodServe EMA-routed proxy in front of the port's
inference engines.

Counterpart of ``repro/launch/serve.py``: the same submit loop, routing each
request to the engine with the least EMA-estimated decode time times its
load, the same stepping loop feeding ``drain_events()`` into the
``EMAEstimator``, and the same per-engine TPOT/prefill report.  Differences:
the load counts queued and staged requests as well as running ones (all
requests are submitted before the first step, so counting running ones
alone sends every request to engine 0); the engines share one weight set;
odd-numbered engines use chunked prefill where the config allows it (full
and window attention only: mamba and MLA layers prefill in one shot), so
one fleet serves through both prefill paths.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.1-8b \\
      --n-requests 12 --engines 2                       # full width, CUDA
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --size reduced [--arch deepseek-v2-lite-16b]

``--arch`` takes every id of ``configs.ALL_ARCHS``: the dense llama3.1-8b,
qwen2.5-14b, minicpm-2b, qwen3-32b, internvl2-1b and musicgen-medium
(the last two text-only), gemma3-27b and gemma3-12b (5:1 window:full
layers, the window layers over per-slot rings), mamba2-1.3b,
deepseek-v2-lite-16b (MLA over a per-slot latent cache, MoE),
jamba-v0.1-52b (mamba, attention, MoE) and mixtral-8x22b (window layers,
MoE).  At ``--size full`` one card holds deepseek-v2-lite-16b (31.4 GB of
bf16 weights), gemma3-27b (54.0 GB) and gemma3-12b (23.5 GB, head dim
256) whole; qwen3-32b needs ``build_engines(..., max_batch=4)``;
jamba-v0.1-52b (102.9 GB) fits only cut to two of its four periods
(``cut_periods``: 16 of 32 layers, 52.0 GB) and mixtral-8x22b (281.3 GB)
only cut to 8 of its 56 layers (``cut_periods(cfg, 8)``, 40.9 GB): configs
that ``build_engines`` takes and the CLI does not build.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import ALL_ARCHS, get_config, reduce_config
from repro_torch.core.estimator import EMAEstimator
from repro_torch.device import resolve_device
from repro_torch.engine.engine import EngineRequest, InferenceEngine
from repro_torch.models.model import init_params

# full: the published widths in bf16 on one card; reduced: the CPU smoke size
SIZES: Dict[str, dict] = {
    "full": dict(dtype=torch.bfloat16, max_batch=8, max_len=4096,
                 page_size=16, prefill_chunk=512, prompt_len=(128, 2048)),
    "reduced": dict(dtype=torch.float32, max_batch=4, max_len=96,
                    page_size=16, prefill_chunk=8, prompt_len=(8, 24)),
}


def cut_periods(cfg, periods: int):
    """``cfg`` at full width with its one stage repeated ``periods`` times:
    depth cut to fit the card (jamba-v0.1-52b at 2 of its 4 periods,
    mixtral-8x22b, whose stage is one layer, at 8 of 56)."""
    (stage,) = cfg.stages
    return dataclasses.replace(
        cfg, num_layers=len(stage.pattern) * periods,
        stages=(dataclasses.replace(stage, repeat=periods),))


def alternate_windows(cfg, sizes):
    """``cfg`` with the window layers of each stage's pattern taking the
    window ``sizes`` in turn (1024 and 512: 1024, 512, 1024, ... in each
    pattern), every other layer as it is: window layers of different
    sizes, which no published config has and the model runs as the
    reference does.  Only ``dataclasses.replace`` on the config, its
    stages and their blocks."""
    stages = []
    for st in cfg.stages:
        turn = iter(sizes * len(st.pattern))
        stages.append(dataclasses.replace(st, pattern=tuple(
            dataclasses.replace(b, window=next(turn))
            if b.mixer == "window" else b for b in st.pattern)))
    return dataclasses.replace(cfg, stages=tuple(stages))


def build_engines(cfg, n_engines: int, size: str, device, seed: int = 0,
                  max_batch: Optional[int] = None,
                  dtype: Optional[torch.dtype] = None) -> List[InferenceEngine]:
    """``n_engines`` engines over one shared weight set; odd-numbered ones
    stage prompts through chunked prefill.  ``max_batch`` overrides the
    size's slots per engine (qwen3-32b's 65.5 GB of bf16 weights leave
    room for two engines of 4 slots at ``max_len`` 4096 on an 80 GB
    card, not of 8); ``dtype`` the size's weight and cache dtype (fp32 at
    full width is the JAX engine's own dtype: llama3.1-8b's 32.1 GB of
    weights and 2 x 8 slots of 4096 tokens fit one card)."""
    s = SIZES[size]
    dev = resolve_device(device)
    params = init_params(cfg, seed=seed, dtype=dtype or s["dtype"],
                         device=dev)
    return [InferenceEngine(cfg, params,
                            max_batch=max_batch or s["max_batch"],
                            max_len=s["max_len"], page_size=s["page_size"],
                            prefill_chunk=s["prefill_chunk"] if i % 2 else None,
                            device=dev)
            for i in range(n_engines)]


def make_requests(cfg, n: int, max_new: int, size: str,
                  seed: int = 0) -> List[EngineRequest]:
    lo, hi = SIZES[size]["prompt_len"]
    rng = np.random.default_rng(seed)
    out = []
    for rid in range(n):
        prompt = [int(t) for t in
                  rng.integers(0, cfg.vocab_size, int(rng.integers(lo, hi)))]
        out.append(EngineRequest(rid=rid, tokens=prompt,
                                 prompt_len=len(prompt),
                                 max_new_tokens=max_new))
    return out


def route(engines: List[InferenceEngine], est: EMAEstimator) -> int:
    """The engine with the least EMA decode time times (1 + its load)."""
    return min(range(len(engines)),
               key=lambda i: est.snapshot(i).d * (1 + engines[i].load))


def serve(engines: List[InferenceEngine], requests: List[EngineRequest],
          max_steps: int = 100000) -> dict:
    """Route ``requests`` over ``engines`` and step them all until every
    request finished.  Returns the estimator, every drained timing event per
    engine, the routing and the wall time."""
    est = EMAEstimator()
    routed = []
    for req in requests:
        gid = route(engines, est)
        engines[gid].submit(req)
        routed.append(gid)
    events: List[list] = [[] for _ in engines]
    t0 = time.perf_counter()
    for _ in range(max_steps):
        done = 0
        for gid, eng in enumerate(engines):
            eng.step()
            for kind, size, dt in eng.drain_events():
                if kind == "decode":
                    est.observe_decode_iter(gid, dt)
                else:
                    est.observe_prefill(gid, size, dt)
                events[gid].append((kind, size, dt))
            done += len(eng.completed)
        if done >= len(requests):
            break
    else:
        raise RuntimeError(f"requests unfinished after {max_steps} steps")
    return {"estimator": est, "events": events, "routed": routed,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.1-8b",
                    help=f"one of {', '.join(ALL_ARCHS)} (at --size full, "
                    f"jamba-v0.1-52b and mixtral-8x22b do not fit one card "
                    f"whole: build them with build_engines(cut_periods(...)))")
    ap.add_argument("--engines", type=int, default=2)
    ap.add_argument("--n-requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", choices=sorted(SIZES), default="full")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.size == "reduced":
        cfg = reduce_config(cfg)
    engines = build_engines(cfg, args.engines, args.size, args.device)
    requests = make_requests(cfg, args.n_requests, args.max_new, args.size)
    report = serve(engines, requests)
    total_tokens = sum(len(r.generated) for e in engines for r in e.completed)
    print(f"served {args.n_requests} requests, {total_tokens} tokens in "
          f"{report['seconds']:.1f}s across {args.engines} engines "
          f"on {engines[0].device}")
    for gid, eng in enumerate(engines):
        e = report["estimator"].snapshot(gid)
        print(f"  engine{gid}: served={len(eng.completed)} "
              f"d_ema={e.d * 1e3:.1f}ms/tok p_ema={e.p * 1e6:.0f}us/tok")
    report["engines"] = engines
    return report


if __name__ == "__main__":
    main()
