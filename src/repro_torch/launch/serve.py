"""Serving launcher: the GoodServe EMA-routed proxy in front of the port's
inference engines.

Counterpart of ``repro/launch/serve.py``: the same submit loop, routing each
request to the engine with the least EMA-estimated decode time times its
load, the same stepping loop feeding ``drain_events()`` into the
``EMAEstimator``, and the same per-engine TPOT/prefill report.  Differences:
the load counts queued and staged requests as well as running ones (all
requests are submitted before the first step, so counting running ones
alone sends every request to engine 0); the engines share one weight set;
odd-numbered engines use chunked prefill, so one fleet serves through both
prefill paths.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.1-8b \\
      --n-requests 12 --engines 2                       # full width, CUDA
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --size reduced
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs import get_config, reduce_config
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


def build_engines(cfg, n_engines: int, size: str, device,
                  seed: int = 0) -> List[InferenceEngine]:
    """``n_engines`` engines over one shared weight set; odd-numbered ones
    stage prompts through chunked prefill."""
    s = SIZES[size]
    dev = resolve_device(device)
    params = init_params(cfg, seed=seed, dtype=s["dtype"], device=dev)
    return [InferenceEngine(cfg, params, max_batch=s["max_batch"],
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
    ap.add_argument("--arch", default="llama3.1-8b")
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
