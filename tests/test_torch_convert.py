"""The weight bridge round-trips the JAX parameter tree leaf by leaf (MLA's
and window layers' ``attn`` dicts and MoE ``ffn`` dicts with their nested
``shared`` experts too), and the port's config copies match the JAX package's field by
field."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduce_config as jax_reduce  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.models.convert import from_jax_params, to_numpy_tree  # noqa: E402

ARCHS = ["llama3.1-8b", "qwen2.5-14b", "mamba2-1.3b", "minicpm-2b", "qwen3-32b",
         "internvl2-1b", "musicgen-medium", "deepseek-v2-lite-16b",
         "jamba-v0.1-52b", "gemma3-27b", "gemma3-12b", "mixtral-8x22b"]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _leaves(t, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("arch", ARCHS)
def test_from_jax_then_to_numpy_is_identity(arch, dtype):
    jcfg = jax_reduce(jax_get_config(arch), layers_per_stage=2)
    tcfg = reduce_config(get_config(arch), layers_per_stage=2)
    params = jax.tree.map(np.asarray,
                          jax_init_params(jcfg, jax.random.PRNGKey(1), dtype))
    model = from_jax_params(params, tcfg, device="cpu")
    # two layers per stage: 2 for the one-layer patterns, deepseek's dense
    # first stage of 1 then 2 MoE layers, jamba's period of 8 twice,
    # gemma3's 5:1 period twice (gemma3-27b: then its 2 trailing window
    # layers once)
    assert len(model.layers) == tcfg.num_layers == sum(
        len(st.pattern) * min(st.repeat, 2) for st in get_config(arch).stages)
    want = dict(_leaves(params))
    got = dict(_leaves(to_numpy_tree(model)))
    assert sorted(got) == sorted(want)
    for path, a in want.items():
        b = got[path]
        assert b.shape == a.shape, path
        np.testing.assert_array_equal(b, np.asarray(a, np.float32),
                                      err_msg=path)
    if dtype == jnp.bfloat16:
        assert model.dtype == torch.bfloat16
        for blk in model.layers:
            if blk.spec.ffn == "moe":
                assert blk.ffn["router"].dtype == torch.float32


PORT_ONLY_FIELDS = {"position_embedding": "rope", "embedding_multiplier": 1.0,
                    "residual_multiplier": 1.0, "attention_multiplier": None,
                    "logits_scaling": 1.0}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_copies_match_jax(arch, reduced):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    if reduced:
        jcfg, tcfg = jax_reduce(jcfg), reduce_config(tcfg)
    # the port's own fields (NoPE, the muP scalars) sit at their defaults
    # in every config of the JAX package; every other field is the JAX one
    port = dataclasses.asdict(tcfg)
    assert {k: port.pop(k) for k in PORT_ONLY_FIELDS} == PORT_ONLY_FIELDS
    assert port == dataclasses.asdict(jcfg)
    assert [dataclasses.astuple(b) for b in tcfg.layer_list()] == \
        [dataclasses.astuple(b) for b in jcfg.layer_list()]
    for active_only in (False, True):
        assert tcfg.param_count(active_only=active_only) == \
            jcfg.param_count(active_only=active_only)


def test_moe_shared_experts_flatten_and_nest_again():
    """A MoE ``ffn`` holds its shared experts flat (``shared_w_gate``, ...);
    the tree that comes back nests them under ``shared`` again."""
    jcfg = jax_reduce(jax_get_config("deepseek-v2-lite-16b"))
    tcfg = reduce_config(get_config("deepseek-v2-lite-16b"))
    params = jax.tree.map(np.asarray, jax_init_params(
        jcfg, jax.random.PRNGKey(2), jnp.float32))
    model = from_jax_params(params, tcfg, device="cpu")
    ffn = model.layers[1].ffn
    assert sorted(ffn) == ["ln", "router", "shared_w_down", "shared_w_gate",
                           "shared_w_up", "w_down", "w_gate", "w_up"]
    assert "shared" not in model.layers[0].ffn       # layer 0: dense FFN
    back = to_numpy_tree(model)["stages"][1]["blk0"]["ffn"]
    assert sorted(back["shared"]) == ["w_down", "w_gate", "w_up"]
    np.testing.assert_array_equal(
        back["shared"]["w_up"], params["stages"][1]["blk0"]["ffn"]["shared"]
        ["w_up"])
    assert sorted(model.layers[0].attn) == ["kv_norm", "ln", "w_dkv",
                                            "w_uk", "w_uv", "wo", "wq"]
