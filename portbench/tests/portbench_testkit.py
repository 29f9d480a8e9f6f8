"""Helpers of the benchmark's CPU tests: paths, and the cells of
``BENCHMARK.json`` cut to a size the CPU holds (the same files, with every
width cut by the configuration's own reference, ``reduced(conf)``, and the
traffic shrunk), driven through ``pb.runner.run_cell`` past the look for a
card."""
from __future__ import annotations

import copy
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

CELLS = tuple(w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"])


def reduced_config(conf: dict, bench_dir: Path = BENCH) -> dict:
    """``conf`` at a CPU size: its reference's ``reduced`` cut, served in
    float32 by two engines of 4 slots of 128 tokens."""
    from pb import spec
    c = spec.reference(conf, bench_dir).reduced(conf)
    # float32 at this size: the program then reads a gap of about 0, so
    # a check that fails tells a fault from rounding
    c["serving"] = dict(c["serving"], max_batch=4, max_len=128,
                        prefill_chunk=16, dtype="float32")
    return c


def reduced_cell(name: str, limit: float = 0.05, root: Path = ROOT,
                 bench_dir: Path = BENCH):
    """The cell of ``root``'s BENCHMARK.json at a CPU size: reduced config,
    the mix cut to prompts of 8-60 and outputs of 4-30 tokens, a 1 s
    warm-up."""
    from pb import spec
    cell = spec.load_cell(root, name, bench_dir)
    cell.config = reduced_config(cell.config, bench_dir)
    t = copy.deepcopy(cell.traffic)
    t["mix"] = {"kind": "uniform", "input": [8, 60], "output": [4, 30]}
    if t.get("first_round"):
        t["first_round"] = {"output": [2, 30]}
    t["clients"] = min(int(t.get("clients", 0)), 12)
    t["warmup_s"], t["drain_s"] = 1.0, 2.0
    cell.traffic = t
    # the cell's own kind of limit, at this size's value: float32 reads a
    # gap of about 0 (a mean limit takes a tenth of the widest one's)
    kind = next(iter(cell.settings["limits"]))
    cell.settings = dict(cell.settings, rate_rps=30.0, check_tokens=60,
                         limits={kind: limit if kind == "logit_gap"
                                 else limit / 10})
    return cell


def run_reduced(name: str, seed: int = 2 ** 31 + 77, seconds: float = 3.0,
                fault=None, check_mode: str = "fp32", limit: float = 0.05):
    import torch
    from pb.runner import run_cell
    torch.set_num_threads(1)
    return run_cell(reduced_cell(name, limit), seed, seconds, False, "cpu",
                    time.perf_counter(), fault=fault, check_mode=check_mode)


# faults planted under a run: each must make ``correct`` come out false

def fault_state_unchanged(monkeypatch):
    """The decode step leaves its cache as it found it: the new token's
    K/V, latent rows or Mamba states are never kept (every tensor of the
    step's cache is put back)."""
    import torch
    import repro_torch.engine.engine as E
    real = E.decode_step

    def tensors(tree):
        if isinstance(tree, dict):
            tree = list(tree.values())
        if isinstance(tree, (list, tuple)):
            return [t for v in tree for t in tensors(v)]
        return [tree] if isinstance(tree, torch.Tensor) else []

    def step(model, tokens, cache):
        keep = [(t, t.clone()) for t in tensors(cache)]
        out = real(model, tokens, cache)
        for t, v in keep:
            t.copy_(v)
        return out
    monkeypatch.setattr(E, "decode_step", step)
    return lambda engines: None


def fault_half_batch(monkeypatch):
    """Half of the decode batch left out, a different half each step: its
    rows get the mean of the other rows' logits."""
    def plant(engines):
        for eng in engines:
            real, turn = eng._step_logits, [0]

            def logits(real=real, turn=turn):
                lg = real()
                turn[0] ^= 1
                lg[turn[0]::2] = lg[1 - turn[0]::2].mean(dim=0)
                return lg
            eng._step_logits = logits
    return plant


def fault_altered_token(monkeypatch):
    """Each decoded token altered where it is produced (id + 1)."""
    def plant(engines):
        for eng in engines:
            real = eng._decode_body
            V = eng.cfg.vocab_size

            def body(real=real, V=V):
                out = real()
                out[0] = (out[0] + 1) % V
                return out
            eng._decode_body = body
    return plant


FAULTS = {"state_unchanged": fault_state_unchanged,
          "half_batch": fault_half_batch,
          "altered_token": fault_altered_token}
