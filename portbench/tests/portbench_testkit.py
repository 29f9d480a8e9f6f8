"""Helpers of the benchmark's CPU tests: paths, and the cells cut to a
size the CPU holds (the same files, with every width and the traffic
shrunk), driven through ``pb.runner.run_cell`` past the look for a card."""
from __future__ import annotations

import copy
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

CELLS = ("minicpm-2b.agentic", "deepseek-v2-lite-16b.agentic_saturated",
         "minicpm-2b.long_session")


def reduced_config(conf: dict) -> dict:
    """``conf`` at a CPU size: the same architecture, small widths, the
    reference's keys and the port's section cut alike."""
    c = copy.deepcopy(conf)
    p = c["port"]
    if "mla" in p:
        p.update(d_model=64, num_heads=4, num_kv_heads=4, head_dim=48,
                 d_ff=128, vocab_size=256, num_layers=3,
                 layers=[{"mixer": "mla", "ffn": "dense", "repeat": 1},
                         {"mixer": "mla", "ffn": "moe", "repeat": 2}],
                 moe=dict(num_experts=8, top_k=2, d_ff_expert=32,
                          num_shared=2, d_ff_shared=64, capacity_factor=2.0),
                 mla=dict(kv_lora_rank=32, rope_head_dim=16,
                          nope_head_dim=32, v_head_dim=32))
        c.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
                 intermediate_size=128, vocab_size=256, num_hidden_layers=3,
                 n_routed_experts=8, num_experts_per_tok=2,
                 moe_intermediate_size=32, n_shared_experts=2,
                 kv_lora_rank=32, qk_rope_head_dim=16, qk_nope_head_dim=32,
                 v_head_dim=32)
    else:
        p.update(d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
                 d_ff=128, vocab_size=250, num_layers=2,
                 layers=[{"mixer": "full", "ffn": "dense", "repeat": 2}])
        c.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
                 intermediate_size=128, vocab_size=250, num_hidden_layers=2,
                 dim_model_base=64, scale_depth=2 ** 0.5)
    # float32 at this size: the program then reads a gap of about 0, so
    # a check that fails tells a fault from rounding
    c["serving"].update(max_batch=4, max_len=128, prefill_chunk=16,
                        dtype="float32")
    return c


def reduced_cell(name: str, limit: float = 0.05):
    """The cell of BENCHMARK.json at a CPU size: reduced config, the mix
    cut to prompts of 8-60 and outputs of 4-30 tokens, a 1 s warm-up."""
    from pb import spec
    cell = spec.load_cell(ROOT, name)
    cell.config = reduced_config(cell.config)
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
    K/V (or latent rows) are never kept."""
    import repro_torch.engine.engine as E
    real = E.decode_step

    def step(model, tokens, cache):
        keep = {k: cache[k].clone() for k in ("k_pages", "v_pages", "ckv",
                                               "kr") if k in cache}
        out = real(model, tokens, cache)
        for k, v in keep.items():
            cache[k].copy_(v)
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
