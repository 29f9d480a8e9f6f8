"""A Mamba-2 / attention hybrid with routed experts in every layer enters
the benchmark as added files alone: in a copy of the benchmark's files, a
configuration shaped as one period of granite-4.0-h-small (9 Mamba-2
layers and one full attention layer), a cell and a reference module that
names its leaves and its CPU cut.  ``pb.runner.run_cell`` serves it on
the CPU, with no edit to any file there."""
import json
import math
import shutil
import time

import pytest

torch = pytest.importorskip("torch")

import portbench_testkit as K  # noqa: E402
from pb import program  # noqa: E402
from pb.runner import run_cell  # noqa: E402

CELL = "granite-period.agentic_closed"
DT = 0.01                   # the dt that dt_bias is drawn around

# one period of granite-4.0-h-small at its published widths
CONFIG = {
    "name": "granite-period",
    "source": "https://huggingface.co/ibm-granite/granite-4.0-h-small/blob/main/config.json",
    "reference": "hybrid_leaves",
    "hidden_size": 4096, "num_attention_heads": 32, "num_key_value_heads": 8,
    "mamba_n_heads": 128, "mamba_d_head": 64, "mamba_d_state": 128,
    "mamba_n_groups": 1, "mamba_d_conv": 4, "num_local_experts": 72,
    "num_experts_per_tok": 10, "intermediate_size": 768,
    "shared_intermediate_size": 1536, "vocab_size": 100352,
    "num_hidden_layers": 10, "tie_word_embeddings": True,
    "layer_types": ["mamba"] * 5 + ["attention"] + ["mamba"] * 4,
    "port": {
        "family": "hybrid", "num_layers": 10, "d_model": 4096,
        "num_heads": 32, "num_kv_heads": 8, "head_dim": 128, "d_ff": 768,
        "vocab_size": 100352,
        "layers": [{"pattern": [{"mixer": "mamba", "ffn": "moe"}] * 5
                    + [{"mixer": "full", "ffn": "moe"}]
                    + [{"mixer": "mamba", "ffn": "moe"}] * 4, "repeat": 1}],
        "moe": {"num_experts": 72, "top_k": 10, "d_ff_expert": 768,
                "num_shared": 1, "d_ff_shared": 1536, "capacity_factor": 2.0},
        "ssm": {"d_state": 128, "d_conv": 4, "expand": 2, "head_dim": 64,
                "n_groups": 1, "chunk": 256},
        "tie_embeddings": True, "norm_eps": 1e-05},
    "serving": {"engines": 2, "max_batch": 16, "max_len": 4096,
                "page_size": 16, "prefill_chunk": 512, "dtype": "bfloat16"},
}

REFERENCE = f'''"""Leaves of a Mamba-2 / attention hybrid with routed experts in every
layer, from granite-4.0-h's keys; no forward pass."""
import copy
import math

DT = {DT}


def leaves(conf, vocab_rows):
    d, H = conf["hidden_size"], conf["num_attention_heads"]
    KV, hd = conf["num_key_value_heads"], d // H
    nh, P = conf["mamba_n_heads"], conf["mamba_d_head"]
    di, gn = nh * P, conf["mamba_n_groups"] * conf["mamba_d_state"]
    K, E = conf["mamba_d_conv"], conf["num_local_experts"]
    f, fs = conf["intermediate_size"], conf["shared_intermediate_size"]
    w = lambda n, shape, fan: (n, shape, fan ** -0.5, "weight")
    out = [("top.embed", (vocab_rows, d), d ** -0.5, "embed"),
           ("top.final_norm", (d,), 0.1, "norm")]
    for i, kind in enumerate(conf["layer_types"]):
        if kind == "mamba":
            m = f"layers.{{i}}.mixer."
            out += [(m + "ln", (d,), 0.1, "norm"),
                    w(m + "w_z", (d, di), d), w(m + "w_x", (d, di), d),
                    w(m + "w_B", (d, gn), d), w(m + "w_C", (d, gn), d),
                    w(m + "w_dt", (d, nh), d), w(m + "conv_x", (K, di), K),
                    w(m + "conv_B", (K, gn), K), w(m + "conv_C", (K, gn), K),
                    (m + "conv_bx", (di,), 0.1, "bias"),
                    (m + "conv_bB", (gn,), 0.1, "bias"),
                    (m + "conv_bC", (gn,), 0.1, "bias"),
                    (m + "A_log", (nh,), math.log(nh) / 4, "scalar",
                     math.log(nh) / 2),
                    (m + "D", (nh,), 0.1, "scalar", 1.0),
                    (m + "dt_bias", (nh,), 1.15, "scalar",
                     math.log(math.expm1(DT))),
                    (m + "gn", (di,), 0.1, "norm"),
                    w(m + "out_proj", (di, d), di)]
        else:
            a = f"layers.{{i}}.attn."
            out += [(a + "ln", (d,), 0.1, "norm"),
                    w(a + "wq", (d, H * hd), d), w(a + "wk", (d, KV * hd), d),
                    w(a + "wv", (d, KV * hd), d),
                    w(a + "wo", (H * hd, d), H * hd)]
        m = f"layers.{{i}}.ffn."
        out += [(m + "ln", (d,), 0.1, "norm"),
                (m + "router", (d, E), d ** -0.5, "router"),
                w(m + "w_gate", (E, d, f), d), w(m + "w_up", (E, d, f), d),
                w(m + "w_down", (E, f, d), f),
                w(m + "shared_w_gate", (d, fs), d),
                w(m + "shared_w_up", (d, fs), d),
                w(m + "shared_w_down", (fs, d), fs)]
    return out


def reduced(conf):
    c = copy.deepcopy(conf)
    c["port"].update(d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                     d_ff=32, vocab_size=256,
                     moe=dict(num_experts=8, top_k=2, d_ff_expert=32,
                              num_shared=1, d_ff_shared=64,
                              capacity_factor=2.0),
                     ssm=dict(d_state=16, d_conv=4, expand=2, head_dim=16,
                              n_groups=1, chunk=16))
    c.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
             mamba_n_heads=8, mamba_d_head=16, mamba_d_state=16,
             num_local_experts=8, num_experts_per_tok=2,
             intermediate_size=32, shared_intermediate_size=64,
             vocab_size=256)
    return c
'''


def _bench_copy(tmp_path):
    """The benchmark's files copied, plus the hybrid's config, cell and
    reference: a root holding its own BENCHMARK.json."""
    bench_dir = tmp_path / "portbench"
    for sub in ("configs", "traffic", "cells", "metrics", "reference"):
        shutil.copytree(K.BENCH / sub, bench_dir / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (bench_dir / "reference" / "hybrid_leaves.py").write_text(REFERENCE)
    (bench_dir / "configs" / "granite-period.json").write_text(
        json.dumps(CONFIG))
    (bench_dir / "cells" / f"{CELL}.json").write_text(json.dumps(
        {"check_tokens": 600, "limits": {"logit_gap": 0.3}}))
    bench = json.loads((K.ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": CELL, "config": "granite-period",
                               "traffic": "agentic_closed", "chips": 1,
                               "why": "Mamba-2 state, B3 and MoE"})
    next(m for m in bench["end_to_end"]
         if m["name"] == "output_tokens_per_s")["workloads"].append(CELL)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench_dir


def test_a_hybrid_serves_from_added_files(tmp_path):
    bench_dir = _bench_copy(tmp_path)
    cell = K.reduced_cell(CELL, root=tmp_path, bench_dir=bench_dir)
    cell.config["serving"]["dtype"] = "bfloat16"   # so float32 leaves show
    torch.set_num_threads(1)
    out, weights, _ = run_cell(cell, 2 ** 31 + 5, 3.0, False, "cpu",
                               time.perf_counter(), judge=False)
    assert out.attempted > 0 and out.failed == 0
    assert set(out.metrics) == {"output_tokens_per_s", "setup_s"}
    assert out.metrics["output_tokens_per_s"]["value"] > 0
    # every leaf as the port holds it: A_log, D, dt_bias and the router
    # in float32, the rest in bf16
    lay = program.layout(program.model_config(cell.config), torch.bfloat16)
    assert {n: w.dtype for n, w in weights.items()} == \
        {n: dt for n, (_, dt) in lay.items()}
    f32 = {n.split(".")[-1] for n, (_, dt) in lay.items()
           if dt == torch.float32}
    assert f32 == {"A_log", "D", "dt_bias", "router"}
    dt_bias = torch.cat([w for n, w in weights.items()
                         if n.endswith("dt_bias")])
    assert len(dt_bias) == 9 * 8
    assert abs(dt_bias.mean().item() - math.log(math.expm1(DT))) < 0.6
    d_skip = torch.cat([w for n, w in weights.items() if n.endswith(".D")])
    assert abs(d_skip.mean().item() - 1.0) < 0.1
    c = out.record.counts
    assert (c.mamba_layers(), c.flash_layers()) == (9, 1)
    assert c.kv_bytes_per_token() == 2 * 2 * 16 * 2
    assert c.state_bytes_per_slot() == 9 * (8 * 16 * 16 * 4
                                            + 3 * (128 + 2 * 16) * 2)
    steps = out.record.steps()
    assert steps and c.decode_flops(steps[-1].ctxs) > \
        c.decode_flops([1] * len(steps[-1].ctxs))
