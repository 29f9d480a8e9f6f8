"""A configuration's ``port`` section reaches the port whole: every config
of ``repro_torch.configs`` written as a section comes back from
``program.model_config`` equal to itself, and ``Counts`` counts its
weights as the port holds them.  Keys and kinds that neither knows raise."""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import portbench_testkit  # noqa: E402,F401  (the paths)
from pb import program  # noqa: E402
from pb.counts import Counts  # noqa: E402
from repro_torch.configs import ALL_ARCHS, get_config  # noqa: E402
from repro_torch.configs.base import (BlockSpec, ModelConfig,  # noqa: E402
                                      MoEConfig, SSMConfig, Stage)
from repro_torch.models.model import padded_vocab  # noqa: E402

# granite-4.0-h-small's widths and period (hf:ibm-granite/granite-4.0-h-small):
# 36 Mamba-2 and 4 attention layers, routed experts in every layer; RoPE and
# no muP scalars, as the port runs it
_PERIOD = tuple(BlockSpec("full" if i == 5 else "mamba", "moe")
                for i in range(10))
GRANITE = ModelConfig(
    name="granite-4.0-h-small", family="hybrid", num_layers=40, d_model=4096,
    num_heads=32, num_kv_heads=8, head_dim=128, d_ff=768, vocab_size=100352,
    stages=(Stage(_PERIOD, 4),),
    moe=MoEConfig(num_experts=72, top_k=10, d_ff_expert=768, num_shared=1,
                  d_ff_shared=1536),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk=256),
    tie_embeddings=True, norm_eps=1e-5,
    source="https://huggingface.co/ibm-granite/granite-4.0-h-small")
CONFIGS = {**{a: get_config(a) for a in ALL_ARCHS}, GRANITE.name: GRANITE}


def port_section(cfg: ModelConfig) -> dict:
    """``cfg`` as a configuration file's ``port`` section holds it: every
    field, sub-configs as objects, a stage of one layer kind as one entry
    and a longer period as a pattern, through JSON."""
    def block(b):
        return {"mixer": b.mixer, "ffn": b.ffn,
                **({"window": b.window} if b.window else {})}
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name in ("name", "source"):
            continue
        if f.name == "stages":
            out["layers"] = [
                dict(block(s.pattern[0]), repeat=s.repeat)
                if len(s.pattern) == 1 else
                {"pattern": [block(b) for b in s.pattern], "repeat": s.repeat}
                for s in v]
        elif dataclasses.is_dataclass(v):
            out[f.name] = dataclasses.asdict(v)
        else:
            out[f.name] = v
    return json.loads(json.dumps(out))


def _conf(cfg):
    return {"name": cfg.name, "source": cfg.source, "port": port_section(cfg)}


@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_every_config_round_trips_through_a_port_section(arch):
    cfg = CONFIGS[arch]
    assert program.model_config(_conf(cfg)) == cfg


@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_counts_weigh_what_the_port_holds(arch):
    """Σ the port's parameters = ``Counts.all_params()`` + what it leaves
    out: the vectors (norms, biases, a Mamba layer's per-head A_log, D and
    dt_bias) and the padded vocabulary rows of the embedding and head."""
    cfg = CONFIGS[arch]
    lay = program.layout(cfg, torch.bfloat16)
    total = sum(torch.Size(shape).numel() for shape, _ in lay.values())
    vectors = sum(shape[0] for shape, _ in lay.values() if len(shape) == 1)
    heads = 1 if cfg.tie_embeddings else 2
    padded = (padded_vocab(cfg) - cfg.vocab_size) * cfg.d_model * heads
    c = Counts.of(_conf(cfg))
    assert total == c.all_params() + vectors + padded
    kinds = [b.mixer for b in cfg.layer_list()]
    assert c.mamba_layers() == kinds.count("mamba")
    assert c.flash_layers() == kinds.count("full") + kinds.count("window")


def test_granite_counts_as_the_issue_sizes_it():
    c = Counts.of(_conf(GRANITE))
    assert c.all_params() == pytest.approx(32.2e9, rel=0.01)
    assert c.kv_bytes_per_token() == 4 * 2 * 8 * 128 * 2        # 16 KB
    assert c.state_bytes_per_slot() == 36 * (128 * 64 * 128 * 4
                                             + 3 * (8192 + 2 * 128) * 2)


def test_a_window_caps_the_pairs_it_counts():
    cfg = get_config("mixtral-8x22b")        # window 4096 in every layer
    c = Counts.of(_conf(cfg))
    pair = 4 * 48 * 128
    base = c.decode_flops([1]) - pair * 56
    assert c.decode_flops([5000]) == base + pair * 56 * 4096
    assert c.prefill_flops(4100) - c.prefill_flops(4096) == \
        2 * c.layer_params(True) * 4 + pair * 56 * 4 * 4096


@pytest.mark.parametrize("bad, match", [
    ({"rope": 1.0}, "'rope'"),
    ({"stages": []}, "'stages'"),
    ({"moe": {"num_experts": 8, "top_k": 2, "d_ff_expert": 4, "shards": 2}},
     "shards"),
    ({"layers": [{"mixer": "full", "ffn": "dense", "repeat": 2,
                  "chunk": 1}]}, "chunk"),
    ({"layers": [{"pattern": [{"mixer": "full", "ffn": "dense", "gate": 1}],
                  "repeat": 2}]}, "gate"),
    ({"layers": [{"mixer": "linear", "ffn": "dense", "repeat": 2}]},
     "linear"),
])
def test_model_config_refuses_what_it_does_not_know(bad, match):
    conf = _conf(get_config("llama3.1-8b"))
    conf["port"]["num_layers"] = 2
    conf["port"]["layers"] = [{"mixer": "full", "ffn": "dense", "repeat": 2}]
    conf["port"].update(bad)
    with pytest.raises(ValueError, match=match):
        program.model_config(conf)


@pytest.mark.parametrize("mixer, ffn", [("linear", "dense"),
                                        ("full", "sparse")])
def test_counts_refuse_a_kind_they_do_not_know(mixer, ffn):
    conf = _conf(get_config("llama3.1-8b"))
    conf["port"]["layers"] = [{"mixer": mixer, "ffn": ffn, "repeat": 32}]
    with pytest.raises(ValueError, match=mixer if mixer != "full" else ffn):
        Counts.of(conf)

