"""The two configurations of the benchmark get what they got before the
harness took any kind of layer: the same ``ModelConfig``, the same drawn
weights bit for bit, and the same counts.  The harness's earlier code is
kept here as the reference (``_model_config_before``, ``_draw_before``);
the counts are numbers it gave, recorded at fixed shapes."""
from collections import defaultdict

import pytest

torch = pytest.importorskip("torch")

import portbench_testkit as K  # noqa: E402
from pb import program, spec, weights as wts  # noqa: E402
from pb.counts import Counts  # noqa: E402
from repro_torch.configs.base import (BlockSpec, MLAConfig, ModelConfig,  # noqa: E402
                                      MoEConfig, Stage)

CONFIGS = {"minicpm-2b": "minicpm-2b.agentic",
           "deepseek-v2-lite-16b": "deepseek-v2-lite-16b.agentic_saturated"}

# Counts at fixed shapes: decode over contexts [7, 100, 1025], prefill of 3
# and of 1000 tokens, a flash call of 512 queries over 1536 keys, a paged
# call over [10, 30, 1025]
RECORDED = {
    "minicpm-2b": dict(
        decode=16765466112, prefill3=15219085824, prefill1000=5068812685824,
        flash=(6042157056, 18874368), paged=(9815040, 9842688), kv=368640,
        all_params=2724694272, active=2441871360, flash_layers=40),
    "deepseek-v2-lite-16b": dict(
        decode=15020826624, prefill3=13870649344, prefill1000=4621984358400,
        flash=(8056209408, 25165824), paged=(13086720, 13123584), kv=31104,
        all_params=15706357760, active=2241593344, flash_layers=0),
}


def _conf(name):
    return spec.load_cell(K.ROOT, CONFIGS[name]).config


def _model_config_before(conf: dict) -> ModelConfig:
    p = conf["port"]
    stages = tuple(Stage(pattern=(BlockSpec(l["mixer"], l["ffn"]),),
                         repeat=l["repeat"]) for l in p["layers"])
    return ModelConfig(
        name=conf["name"], family=p["family"], num_layers=p["num_layers"],
        d_model=p["d_model"], num_heads=p["num_heads"],
        num_kv_heads=p["num_kv_heads"], head_dim=p["head_dim"],
        d_ff=p["d_ff"], vocab_size=p["vocab_size"], stages=stages,
        moe=MoEConfig(**p["moe"]) if "moe" in p else None,
        mla=MLAConfig(**p["mla"]) if "mla" in p else None,
        rope_theta=p["rope_theta"], tie_embeddings=p["tie_embeddings"],
        act=p["act"], norm_eps=p["norm_eps"], source=conf["source"])


def _draw_before(leaves, seed: int, dtype, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(int(seed))
    groups = defaultdict(list)
    for name, shape, std, kind in leaves:
        dt = torch.float32 if kind == "router" else dtype
        groups[(std, dt)].append((name, shape, kind))
    out = {}
    for (std, dt), members in sorted(groups.items(),
                                     key=lambda kv: (kv[0][0], str(kv[0][1]))):
        sizes = [wts._numel(shape) for _, shape, _ in members]
        flat = torch.empty(sum(sizes), dtype=dt, device=device)
        for start in range(0, flat.numel(), wts.DRAW):
            flat[start:start + wts.DRAW].normal_(0.0, std, generator=gen)
        for (name, shape, _), part in zip(members, flat.split(sizes)):
            out[name] = part.view(shape)
    return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_counts_are_the_recorded_ones(name):
    c, r = Counts.of(_conf(name)), RECORDED[name]
    assert c.decode_flops([7, 100, 1025]) == r["decode"]
    assert c.prefill_flops(3) == r["prefill3"]
    assert c.prefill_flops(1000) == r["prefill1000"]
    assert c.flash_call(512, 1536) == r["flash"]
    assert c.paged_call([10, 30, 1025]) == r["paged"]
    assert c.kv_bytes_per_token() == r["kv"]
    assert c.all_params() == r["all_params"]
    assert c.layer_params(True) == r["active"]
    assert c.flash_layers() == r["flash_layers"]
    assert c.mamba_layers() == 0 and c.state_bytes_per_slot() == 0


@pytest.mark.parametrize("cut", [False, True], ids=["published", "cpu_cut"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_model_config_is_the_one_built_before(name, cut):
    conf = _conf(name)
    if cut:
        conf = K.reduced_config(conf)
    assert program.model_config(conf) == _model_config_before(conf)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_weights_are_drawn_bit_for_bit_as_before(name, dtype):
    conf = K.reduced_config(_conf(name))
    dt = program.DTYPES[dtype]
    cfg = program.model_config(conf)
    lay = program.layout(cfg, dt)
    leaves = spec.reference(conf).leaves(conf, lay["top.embed"][0][0])
    seed = 2 ** 31 + 1234
    got = wts.draw(leaves, seed, lay, "cpu")
    want = _draw_before(leaves, seed, dt, "cpu")
    assert list(got) == list(want)
    for n in want:
        assert got[n].dtype == want[n].dtype == lay[n][1], n
        assert torch.equal(got[n], want[n]), n
