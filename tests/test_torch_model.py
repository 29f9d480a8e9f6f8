"""Parity of the port's dense decoder with the JAX package on bridged fp32
weights: norms, RoPE, one attention layer, prefill, chunked prefill and
paged decode.  Tolerance 1e-4: both run fp32, but the frameworks order
their matmul sums differently."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduce_config as jax_reduce  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.engine.kv_cache import PagedKVCache  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


@pytest.fixture(scope="module")
def bridged():
    jcfg = jax_reduce(jax_get_config("llama3.1-8b"), layers_per_stage=2)
    tcfg = reduce_config(get_config("llama3.1-8b"), layers_per_stage=2)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                            device="cpu")
    return jcfg, tcfg, params, model


def test_rms_norm_and_rope():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32) * 0.1
    pos = np.stack([np.arange(5), np.arange(100, 105)]).astype(np.int32)
    np.testing.assert_allclose(
        _np(TL.rms_norm(torch.from_numpy(x), torch.from_numpy(w))),
        _np(JL.rms_norm(jnp.asarray(x), jnp.asarray(w))), **TOL)
    np.testing.assert_allclose(
        _np(TL.rope(torch.from_numpy(x), torch.from_numpy(pos), 500000.0)),
        _np(JL.rope(jnp.asarray(x), jnp.asarray(pos), 500000.0)), **TOL)


def test_attention_layer(bridged):
    jcfg, tcfg, params, model = bridged
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 33, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(33), (2, 33)).astype(np.int32)
    jp = jax.tree.map(lambda a: a[0], params["stages"][0]["blk0"]["attn"])
    jy, (jk, jv) = JL.attn_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                                   None)
    p = model.layers[0].attn
    xt, post = torch.from_numpy(x), torch.from_numpy(pos).long()
    ty, (tk, tv) = TL.attn_forward(p, tcfg, xt, post, None)
    for a, b in ((ty, jy), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)
    # the flash path against the plain _sdpa reference of the same layer
    h = TL.rms_norm(xt, p["ln"], tcfg.norm_eps)
    q, k, v = TL._qkv(p, tcfg, h, post)
    ref = TL._sdpa(q, k, v, TL.causal_mask(33, 33)) @ p["wo"]
    np.testing.assert_allclose(_np(ty), _np(ref), **TOL)


def test_model_forward_and_prefill_logits(bridged):
    jcfg, tcfg, params, model = bridged
    toks = np.random.default_rng(2).integers(0, tcfg.vocab_size, (2, 40))
    jh, _ = JM.model_forward(params, jcfg, jnp.asarray(toks, jnp.int32),
                             remat=False)
    th, _ = TM.model_forward(model, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(th), _np(jh), **TOL)
    jl, _ = JM.prefill(params, jcfg, jnp.asarray(toks, jnp.int32), max_len=64)
    tl, kv = TM.prefill(model, torch.from_numpy(toks))
    assert tl.shape == (2, TM.padded_vocab(tcfg))
    assert len(kv) == tcfg.num_layers and kv[0][0].shape == (2, 40, 1, 16)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)


def test_prefill_chunk_ragged_final_chunk(bridged):
    jcfg, tcfg, params, model = bridged
    prompt = np.random.default_rng(3).integers(0, tcfg.vocab_size, 17)
    C = 8
    jcache = JM.init_cache(jcfg, 1, 64, dtype=jnp.float32, ring=False)
    tcache = TM.init_cache(tcfg, 1, 64, dtype=torch.float32, device="cpu")
    for s in range(0, 17, C):
        n = min(C, 17 - s)
        padded = np.zeros((1, C), np.int32)
        padded[0, :n] = prompt[s:s + n]
        jl, jcache = JM.prefill_chunk(params, jcfg, jcache,
                                      jnp.asarray(padded),
                                      n_valid=jnp.asarray([n], jnp.int32))
        tl, tcache = TM.prefill_chunk(
            model, tcache, torch.from_numpy(prompt[s:s + n])[None])
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    assert tcache["pos"] == 17
    # the staged rows equal a one-shot prefill's K/V
    _, kv = TM.prefill(model, torch.from_numpy(prompt)[None])
    for i, (k, v) in enumerate(kv):
        np.testing.assert_allclose(_np(tcache["k"][i, :, :17]), _np(k), **TOL)
        np.testing.assert_allclose(_np(tcache["v"][i, :, :17]), _np(v), **TOL)


def test_decode_steps_over_paged_cache(bridged):
    jcfg, tcfg, params, model = bridged
    rng = np.random.default_rng(4)
    toks = rng.integers(0, tcfg.vocab_size, (2, 13))
    jl, jcache = JM.prefill(params, jcfg, jnp.asarray(toks, jnp.int32),
                            max_len=32)
    tl, kv = TM.prefill(model, torch.from_numpy(toks))
    cache = PagedKVCache(tcfg, num_pages=12, page_size=4, slots=2, max_len=32,
                         dtype=torch.float32, device="cpu")
    for b in range(2):
        cache.allocate(b, 13)
        idx = cache.token_index(b, 0, 13)
        for layer, (k, v) in enumerate(kv):
            cache.write(layer, idx, k[b], v[b])
    nxt = np.asarray(jnp.argmax(jl, axis=-1))
    for _ in range(3):
        jl, jcache = JM.decode_step(params, jcfg, jcache,
                                    jnp.asarray(nxt[:, None], jnp.int32))
        for b in range(2):
            cache.extend(b, 1)
        view = cache.decode_view()          # every slot, 8 pages wide
        tl = TM.decode_step(model, torch.tensor(nxt, dtype=torch.long), view)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        nxt = np.asarray(jnp.argmax(jl, axis=-1))
    assert list(_np(view["context_lens"])) == [16, 16]
    assert tuple(view["block_tables"].shape) == (2, 8)


def test_unported_mixers_raise():
    """Every mixer of the JAX package is ported (window layers since the
    window slice), and an attention softcap, which no config sets, since
    the softcap slice (``test_torch_softcap.py`` holds it to the JAX
    package); what stays unported raises: a mixer that neither package
    knows and an arch id that neither registers."""
    import dataclasses
    from repro_torch.configs.base import BlockSpec
    cfg = reduce_config(get_config("llama3.1-8b"))
    assert TM.MIXERS == ("full", "window", "mla", "mamba")
    capped = dataclasses.replace(cfg, logit_softcap=30.0)
    TM.check_supported(capped)
    model = TM.init_params(capped, dtype=torch.float32, device="cpu")
    logits, _ = TM.prefill(model, torch.arange(1, 9)[None])
    assert model.cfg.logit_softcap == 30.0
    assert bool(torch.isfinite(logits).all())
    with pytest.raises(ValueError, match="unknown mixer"):
        BlockSpec("linear", "dense")
    with pytest.raises(KeyError, match="supported"):
        get_config("gemma2-9b")
    for arch in ("gemma3-27b", "gemma3-12b", "mixtral-8x22b"):
        TM.check_supported(get_config(arch))
