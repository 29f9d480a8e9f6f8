"""Trace engine steps of a full-width model on the card.

  PYTHONPATH=src python -m repro_torch.launch.profile_step \\
      [--arch llama3.1-8b] [--periods N] [--batch 8] [--prompt 1024] \\
      [--steps 5] [--out build/profile_step] [--train] [--dtype float32]

One engine (bf16 unless ``--dtype float32``, the JAX engine's dtype,
whose prefill runs the split-TF32 flash route; random weights from a
seed; ``--arch`` takes every id
of ``configs.ALL_ARCHS``, gemma3-27b's window layers included;
``--periods`` cuts a one-stage config's depth, as jamba-v0.1-52b and
mixtral-8x22b need) admits ``--batch`` requests
of ``--prompt`` tokens one-shot; the admission step is traced as prefill.
Then ``--steps`` decode steps are traced with ``torch.profiler``: on the
card each is one replay of the engine's CUDA graph, whose kernel nodes the
trace reports like any kernel (the decode line adds ``graph_replays`` and
``capture_s``).  For each
phase it prints one JSON line: wall ms per step, device busy ms per step
(the union of kernel intervals in the trace), kernel launches per step,
device ms per step by kernel name, largest first, by kind (GEMMs, the
port's kernels, softmax, the rest), and, for each of the
port's own CUDA kernels that ran (``kernels/*/csrc``: names in the
top-level ``(anonymous namespace)`` of those sources), its device ms and launches per
step.  The traces go to ``--out``.

With ``--train`` it traces training instead: the config whole, fp32
masters drawn from seed 0, ``--steps`` ``make_train_step`` calls on one
``SyntheticLM`` batch of ``--batch`` x 4096 tokens (a micro-batch of the
grad-accumulation step at train_4k's length), after one untimed step.
"""
from __future__ import annotations

import argparse
import json
import re
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.engine.engine import EngineRequest, InferenceEngine
from repro_torch.launch.serve import cut_periods
from repro_torch.models.model import init_params


def _kernels(trace_path: Path):
    events = json.loads(trace_path.read_text())["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["dur"])) for e in events
            if e.get("cat") == "kernel" and "dur" in e]


# the port's kernels are defined in an anonymous namespace at the top level
# of their .cu; the trace names a template instance with its return type, a
# plain kernel without.  PyTorch has kernels in such a namespace too, so a
# name counts only if a ``__global__`` function of the port's sources has it.
_ANON_KERNEL = re.compile(r"^(?:void )?\(anonymous namespace\)::(\w+)")
_GLOBAL_FN = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                        r"(\w+)\s*\(")


def _port_kernel_names() -> set:
    from repro_torch.kernels import _build
    return {name for files in _build.kernel_sources().values() for f in files
            for name in _GLOBAL_FN.findall(f.read_text())}


def _summary(phase: str, kernels, wall_s: float, steps: int) -> dict:
    busy, end = 0.0, float("-inf")
    for _, ts, dur in sorted(kernels, key=lambda k: k[1]):
        start = max(ts, end)
        if ts + dur > start:
            busy += ts + dur - start
        end = max(end, ts + dur)
    by_name = defaultdict(float)
    for name, _, dur in kernels:
        by_name[name[:80]] += dur
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    port = defaultdict(lambda: [0.0, 0])
    ours = _port_kernel_names()
    for name, _, dur in kernels:
        hit = _ANON_KERNEL.search(name)
        if hit and hit.group(1) in ours:
            port[hit.group(1)][0] += dur
            port[hit.group(1)][1] += 1
    wall_ms = wall_s * 1e3 / steps
    busy_ms = busy / 1e3 / steps
    return {"phase": phase, "steps": steps, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
            "launches_per_step": len(kernels) / steps,
            "device_ms_by_kernel": {n: d / 1e3 / steps for n, d in top},
            "port_kernels": {n: {"ms_per_step": d / 1e3 / steps,
                                 "launches_per_step": c / steps}
                             for n, (d, c) in sorted(port.items())}}


def _traced(phase: str, fn, steps: int, out: Path) -> dict:
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    path = out / f"trace_{phase}.json"
    prof.export_chrome_trace(str(path))
    line = _summary(phase, _kernels(path), wall, steps)
    kinds = defaultdict(float)
    for kind, ms in _kernels_by_kind(path):
        kinds[kind] += ms / steps
    line["device_ms_by_kind"] = dict(kinds)
    return line


TRAIN_SEQ = 4096


def _train_lines(cfg, args, dev, out: Path) -> list:
    from repro_torch.data.lm_data import SyntheticLM
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_step import make_train_step
    model = init_params(cfg, seed=0, dtype=torch.float32, device=dev)
    opt = init_opt_state(dict(model.named_parameters()))
    step = make_train_step(cfg, AdamWConfig(lr=3e-4, warmup_steps=10,
                                            total_steps=100))
    batch = [torch.from_numpy(a).to(dev) for a in
             SyntheticLM(cfg.vocab_size, seed=0).batch(0, args.batch,
                                                       TRAIN_SEQ)]
    step(model, opt, *batch)             # warm-up
    line = _traced("train_step", lambda: step(model, opt, *batch),
                   args.steps, out)
    line.update(seq=TRAIN_SEQ,
                tokens_per_step=args.batch * TRAIN_SEQ,
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    return [line]


# gathers, scatters and indexed writes (``index_put_``, the embedding's
# backward); PyTorch's ``elementwise_kernel_with_index`` is none of them
_INDEX_KERNELS = ("scatter", "gather", "index_put", "indexing",
                  "index_elementwise", "indexselect", "embedding")


def _kernels_by_kind(trace_path: Path):
    """(kind, device ms) of every kernel: "port" (the port's own kernels),
    "gemm" (cuBLAS/CUTLASS matrix products), "softmax", "reduce", "index"
    (gathers, scatters and indexed writes, such as the embedding's
    backward), "copy" (copies, casts and concatenations: PyTorch's
    ``CatArrayBatchedCopy``) or "elementwise/other"."""
    ours = _port_kernel_names()
    for name, _, dur in _kernels(trace_path):
        low = name.lower()
        hit = _ANON_KERNEL.search(name)
        kind = ("port" if hit and hit.group(1) in ours
                else "gemm" if any(k in low for k in ("gemm", "cutlass", "xmma",
                                                  "sm90_", "nvjet"))
                else "softmax" if "softmax" in low
                else "reduce" if "reduce" in low
                else "index" if any(k in low for k in _INDEX_KERNELS)
                else "copy" if "copy" in low
                else "elementwise/other")
        yield kind, dur / 1e3


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.1-8b")
    ap.add_argument("--periods", type=int, default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default="build/profile_step")
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    cfg = get_config(args.arch)
    if args.periods is not None:
        cfg = cut_periods(cfg, args.periods)
    if args.train:
        lines = _train_lines(cfg, args, dev, out)
        for ln in lines:
            ln.update(batch=args.batch, arch=args.arch,
                      num_layers=cfg.num_layers)
            print(json.dumps(ln), flush=True)
        return lines
    params = init_params(cfg, seed=0, dtype=getattr(torch, args.dtype),
                         device=dev)
    eng = InferenceEngine(cfg, params, max_batch=args.batch, max_len=4096,
                          device=dev)
    g = torch.Generator().manual_seed(0)
    reqs = [EngineRequest(rid=rid, prompt_len=args.prompt, max_new_tokens=4096,
                          tokens=torch.randint(0, cfg.vocab_size,
                                               (args.prompt,),
                                               generator=g).tolist())
            for rid in range(args.batch + 1)]
    eng.submit(reqs[0])                  # warm-up: build, prefill, decode
    eng.step()
    eng.checkpoint_request(0)
    for req in reqs[1:]:
        eng.submit(req)
    lines = [_traced("prefill_and_decode", eng.step, 1, out)]
    lines[0]["prefills"] = args.batch
    eng.step()                           # warm the full-batch decode
    replays = eng.graph_replays
    lines.append(_traced("decode", eng.step, args.steps, out))
    lines[1].update(graph_replays=eng.graph_replays - replays,
                    capture_s=eng.capture_s)
    for ln in lines:
        ln.update(batch=args.batch, prompt=args.prompt, arch=args.arch,
                  num_layers=cfg.num_layers, dtype=args.dtype)
        print(json.dumps(ln), flush=True)
    return lines


if __name__ == "__main__":
    main()
