"""The weight bridge round-trips the JAX parameter tree leaf by leaf, and
the port's config copies match the JAX package's field by field."""
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

ARCHS = ["llama3.1-8b", "qwen2.5-14b", "mamba2-1.3b"]


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
    assert len(model.layers) == tcfg.num_layers == 2
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


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_copies_match_jax(arch, reduced):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    if reduced:
        jcfg, tcfg = jax_reduce(jcfg), reduce_config(tcfg)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert [dataclasses.astuple(b) for b in tcfg.layer_list()] == \
        [dataclasses.astuple(b) for b in jcfg.layer_list()]
    for active_only in (False, True):
        assert tcfg.param_count(active_only=active_only) == \
            jcfg.param_count(active_only=active_only)
