"""The dense configs beyond the testbed backends against the JAX package on
bridged fp32 weights: minicpm-2b (MHA, tied embeddings), qwen3-32b
(qk_norm), and internvl2-1b and musicgen-medium, whose stub frontends feed
prefix embeddings through ``prefix_proj``.  Logits within 1e-4 (with the
prefix embeddings where the config has them: their positions shift RoPE
for every token after them); greedy engine tokens identical one-shot and
chunked.  The MoE configs, deepseek-v2-lite-16b (MLA) and jamba-v0.1-52b
(mamba, attention): hidden states and ``prefill`` logits within 1e-4, the
summed aux loss within 1e-5, a MoE layer under chunked prefill, and the
full-width parameter counts.  Plus the copied stage builder and shape
table."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jax_base  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduce_config as jax_reduce  # noqa: E402
from repro.engine.engine import EngineRequest as JReq  # noqa: E402
from repro.engine.engine import InferenceEngine as JEngine  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import base as port_base  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.engine.engine import EngineRequest, InferenceEngine  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["minicpm-2b", "qwen3-32b", "internvl2-1b", "musicgen-medium"]


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


PREFIX_ARCHS = ["internvl2-1b", "musicgen-medium"]


@functools.lru_cache(maxsize=None)
def _bridge(arch):
    jcfg = jax_reduce(jax_get_config(arch), layers_per_stage=2)
    tcfg = reduce_config(get_config(arch), layers_per_stage=2)
    params = JM.init_params(jcfg, jax.random.PRNGKey(3), dtype=jnp.float32)
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                            device="cpu")
    return jcfg, tcfg, params, model


@pytest.fixture(params=ARCHS)
def bridged(request):
    return _bridge(request.param)


def _inputs(cfg, seed, B=2, S=21):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    pre = (rng.standard_normal((B, cfg.n_prefix_embeds, cfg.d_model))
           .astype(np.float32) if cfg.n_prefix_embeds else None)
    return toks, pre


def test_reduced_shapes_keep_the_config_features(bridged):
    _, tcfg, params, model = bridged
    full = get_config(tcfg.name[:-len("-reduced")])
    assert tcfg.qk_norm == full.qk_norm and tcfg.act == full.act
    assert ("q_norm" in model.layers[0].attn) == full.qk_norm
    assert ("lm_head" in model.top) != full.tie_embeddings
    assert ("prefix_proj" in model.top) == bool(full.n_prefix_embeds)
    if full.n_prefix_embeds:
        assert tuple(model.top["prefix_proj"].shape) == (tcfg.d_model,) * 2
        np.testing.assert_array_equal(_np(model.top["prefix_proj"]),
                                      np.asarray(params["prefix_proj"]))


def test_forward_and_prefill_logits_match_jax(bridged):
    jcfg, tcfg, params, model = bridged
    toks, pre = _inputs(tcfg, 11)
    jpre = None if pre is None else jnp.asarray(pre)
    tpre = None if pre is None else torch.from_numpy(pre)
    jh, _ = JM.model_forward(params, jcfg, jnp.asarray(toks, jnp.int32),
                             prefix_embeds=jpre, remat=False)
    th, _ = TM.model_forward(model, torch.from_numpy(toks), tpre)
    n = tcfg.n_prefix_embeds
    assert th.shape == (2, n + toks.shape[1], tcfg.d_model)
    np.testing.assert_allclose(_np(th), _np(jh), **TOL)
    jl, jcache = JM.prefill(params, jcfg, jnp.asarray(toks, jnp.int32),
                            max_len=64, prefix_embeds=jpre)
    tl, kv = TM.prefill(model, torch.from_numpy(toks), tpre)
    assert list(np.asarray(jcache["pos"])) == [n + toks.shape[1]] * 2
    assert kv[0][0].shape[1] == n + toks.shape[1]   # the cache counts them
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    if n:                                   # the prefix changes the logits
        plain, _ = TM.prefill(model, torch.from_numpy(toks))
        assert not np.allclose(_np(plain), _np(tl), **TOL)


@pytest.mark.parametrize("arch", PREFIX_ARCHS)
def test_prefix_positions_shift_rope(arch):
    """The text's K after a prefix of n equals its K computed alone at
    positions n..: the prefix moves positions, not the text's values."""
    _, tcfg, _, model = _bridge(arch)
    n = tcfg.n_prefix_embeds
    assert n > 0
    toks, pre = _inputs(tcfg, 12, B=1, S=5)
    _, kv = TM.prefill(model, torch.from_numpy(toks), torch.from_numpy(pre))
    blk = model.layers[0].attn
    x = TM.embed_tokens(model, torch.from_numpy(toks))
    h = TL.rms_norm(x, blk["ln"], tcfg.norm_eps)
    _, k, _ = TL._qkv(blk, tcfg, h, torch.arange(n, n + 5)[None])
    np.testing.assert_allclose(_np(kv[0][0][:, n:]), _np(k), **TOL)


def _serve(eng, req_cls, prompts, max_new=6):
    for rid, p in enumerate(prompts):
        eng.submit(req_cls(rid=rid, tokens=list(p), prompt_len=len(p),
                           max_new_tokens=max_new))
    return {r.rid: r.generated for r in eng.run_until_drained()}


@pytest.mark.parametrize("chunk", [None, 8])
def test_engine_tokens_match_jax_engine(bridged, chunk):
    """Text-only serving, as the JAX engine serves these configs."""
    jcfg, tcfg, params, model = bridged
    rng = np.random.default_rng(5)
    prompts = [[int(x) for x in rng.integers(0, tcfg.vocab_size, n)]
               for n in (17, 9, 12)]
    got = _serve(InferenceEngine(tcfg, model, max_batch=2, max_len=64,
                                 prefill_chunk=chunk, device="cpu"),
                 EngineRequest, prompts)
    want = _serve(JEngine(jcfg, params, max_batch=2, max_len=64,
                          prefill_chunk=chunk), JReq, prompts)
    assert got == want and len(got) == 3


def test_random_init_draws_the_prefix_projection():
    cfg = reduce_config(get_config("internvl2-1b"))
    model = TM.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    w = model.top["prefix_proj"]
    assert tuple(w.shape) == (cfg.d_model, cfg.d_model)
    assert abs(float(w.std()) - cfg.d_model ** -0.5) < 0.2 * cfg.d_model ** -0.5
    assert "prefix_proj" not in TM.init_params(
        reduce_config(get_config("minicpm-2b")), seed=0, dtype=torch.float32,
        device="cpu").top


@pytest.mark.parametrize("args", [(26, 5, 512), (62, 5, 1024), (12, 3, 64),
                                  (4, 5, 8)])
def test_local_global_stages_match_jax(args):
    t = port_base.local_global_stages(*args)
    j = jax_base.local_global_stages(*args)
    assert [dataclasses.asdict(s) for s in t] == \
        [dataclasses.asdict(s) for s in j]


def test_shapes_and_block_kinds_match_jax():
    assert {k: dataclasses.asdict(v) for k, v in port_base.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jax_base.SHAPES.items()}
    for arch in ARCHS + ["mamba2-1.3b"]:
        t, j = get_config(arch), jax_get_config(arch)
        assert [(si, pi, dataclasses.astuple(b))
                for si, pi, b in t.block_kinds()] == \
            [(si, pi, dataclasses.astuple(b)) for si, pi, b in j.block_kinds()]


MOE_ARCHS = ["deepseek-v2-lite-16b", "jamba-v0.1-52b"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_configs_forward_prefill_and_aux_match_jax(arch):
    jcfg, tcfg, params, model = _bridge(arch)
    toks, _ = _inputs(tcfg, 13, S=23)
    jh, jaux = JM.model_forward(params, jcfg, jnp.asarray(toks, jnp.int32),
                                remat=False)
    th, taux = TM.model_forward(model, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(th), _np(jh), **TOL)
    n_moe = sum(b.ffn == "moe" for b in tcfg.layer_list())
    assert n_moe == (2 if arch.startswith("deepseek") else 8)
    assert float(taux) > 0.5 * n_moe          # each Switch loss is >= 1
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    jl, _ = JM.prefill(params, jcfg, jnp.asarray(toks, jnp.int32), max_len=64)
    tl, states = TM.prefill(model, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    kinds = [k for k, _ in TM.layer_caches(tcfg)]
    for kind, st in zip(kinds, states):
        if kind == "mla":
            assert tuple(st[0].shape) == (2, 23, tcfg.mla.kv_lora_rank)


def test_prefill_chunk_runs_the_moe_ffn_on_each_chunk():
    """Full attention with a MoE FFN (jamba's attention layer alone, two
    deep): chunks of 9 and 8 real tokens, logits as JAX's chunk by chunk."""
    def attn_moe(cfg, base):
        return dataclasses.replace(cfg, name="attn-moe", num_layers=2,
                                   stages=(base.Stage(pattern=(
                                       base.BlockSpec("full", "moe"),),
                                       repeat=2),))
    jcfg = attn_moe(jax_reduce(jax_get_config("jamba-v0.1-52b")), jax_base)
    tcfg = attn_moe(reduce_config(get_config("jamba-v0.1-52b")), port_base)
    params = JM.init_params(jcfg, jax.random.PRNGKey(6), dtype=jnp.float32)
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                            device="cpu")
    toks = np.random.default_rng(8).integers(0, tcfg.vocab_size, (1, 17))
    jcache = JM.init_cache(jcfg, 1, 32, dtype=jnp.float32, ring=False)
    tcache = TM.init_cache(tcfg, 1, 32, dtype=torch.float32, device="cpu")
    for a, b in ((0, 9), (9, 17)):
        jl, jcache = JM.prefill_chunk(params, jcfg, jcache,
                                      jnp.asarray(toks[:, a:b], jnp.int32))
        tl, tcache = TM.prefill_chunk(model, tcache,
                                      torch.from_numpy(toks[:, a:b]))
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    assert tcache["pos"] == 17
    whole, _ = TM.prefill(model, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(tl), _np(whole), **TOL)


def test_full_width_moe_parameter_counts():
    """deepseek-v2-lite-16b whole (31.4 GB in bf16) and jamba-v0.1-52b at
    two of its four periods (52.0 GB), the depth one card serves."""
    ds = get_config("deepseek-v2-lite-16b")
    assert ds.param_count() == 15_706_482_176 == \
        jax_get_config("deepseek-v2-lite-16b").param_count()
    jamba, jj = get_config("jamba-v0.1-52b"), jax_get_config("jamba-v0.1-52b")
    assert jamba.param_count() == 51_459_766_272 == jj.param_count()
    from repro_torch.launch.serve import cut_periods
    two = cut_periods(jamba, 2)
    assert two.num_layers == 16 and two.stages[0].repeat == 2
    assert two.param_count() == 25_998_318_592 == dataclasses.replace(
        jj, num_layers=16, stages=(dataclasses.replace(jj.stages[0],
                                                       repeat=2),)
    ).param_count()
    assert sum(b.mixer == "full" for b in two.layer_list()) == 2
