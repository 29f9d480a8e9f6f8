"""The port's multi-head latent attention against the JAX package's on the
same weights, fp32, within 1e-5: ``mla_forward`` (expanded form, query
chunks of 512) at L=37 and L=1024 and at a ragged L=700, which the JAX
layer takes only in one chunk; ``mla_decode`` (matrix absorption over the
latent rows) over five steps from prefilled rows, rows at different
positions; plus the engine's latent cache and its free rows."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduce_config as jax_reduce  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.engine.latent_cache import LatentCache  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.convert import _to_tensor  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "deepseek-v2-lite-16b"


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


@pytest.fixture(scope="module")
def layer():
    jcfg, tcfg = jax_reduce(jax_get_config(ARCH)), reduce_config(
        get_config(ARCH))
    jp = JL.init_mla(jax.random.PRNGKey(2), jcfg, jnp.float32)
    tp = TL.frozen({k: _to_tensor(np.asarray(a), "cpu")
                    for k, a in jp.items()})
    return jcfg, tcfg, jp, tp


def _x(cfg, B, L, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, L, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("L,jax_chunk", [(37, 512), (1024, 512), (700, 700)])
def test_mla_forward_matches_jax(layer, L, jax_chunk):
    """At L=700 the port scans 512 + 188 query rows; the JAX layer asserts
    L % 512 == 0 above 512, so it runs its one-chunk branch."""
    jcfg, tcfg, jp, tp = layer
    x = _x(tcfg, 2, L, L)
    pos = np.broadcast_to(np.arange(L), (2, L)).astype(np.int32)
    jy, (jc, jk) = JL.mla_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                                  chunk=jax_chunk)
    ty, (tc, tk) = TL.mla_forward(tp, tcfg, torch.from_numpy(x),
                                  torch.from_numpy(pos).long())
    for a, b in ((ty, jy), (tc, jc), (tk, jk)):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)
    assert tuple(tc.shape) == (2, L, tcfg.mla.kv_lora_rank)
    assert tuple(tk.shape) == (2, L, tcfg.mla.rope_head_dim)


def test_mla_decode_five_steps_matches_jax(layer):
    """Two rows prefilled to 12 and 7 tokens, then five decode steps; the
    port's cache is the engine's layout, [slots, S, ·], written in place."""
    jcfg, tcfg, jp, tp = layer
    S, m = 32, tcfg.mla
    jckv = np.zeros((2, S, m.kv_lora_rank), np.float32)
    jkr = np.zeros((2, S, m.rope_head_dim), np.float32)
    for b, n in enumerate((12, 7)):
        x = _x(tcfg, 1, n, 20 + b)
        _, (c, k) = JL.mla_forward(jp, jcfg, jnp.asarray(x),
                                   jnp.arange(n)[None])
        jckv[b, :n], jkr[b, :n] = np.asarray(c[0]), np.asarray(k[0])
    tckv, tkr = torch.from_numpy(jckv.copy()), torch.from_numpy(jkr.copy())
    jckv, jkr = jnp.asarray(jckv), jnp.asarray(jkr)
    pos = np.array([12, 7], np.int32)
    for step in range(5):
        x = _x(tcfg, 2, 1, 40 + step)
        jy, (jckv, jkr) = JL.mla_decode(jp, jcfg, jnp.asarray(x), jckv, jkr,
                                        jnp.asarray(pos))
        ty = TL.mla_decode(tp, tcfg, torch.from_numpy(x), tckv, tkr,
                           torch.from_numpy(pos + 1))
        np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
        np.testing.assert_allclose(_np(tckv), _np(jckv), **TOL)
        np.testing.assert_allclose(_np(tkr), _np(jkr), **TOL)
        pos = pos + 1


def test_free_row_writes_row_zero_of_its_own_slot(layer):
    """A free row (length 0) writes row 0 of its own slot, attends to it
    alone and gives finite output; a live row writes at its length - 1."""
    _, tcfg, _, tp = layer
    S, m = 16, tcfg.mla
    g = torch.Generator().manual_seed(0)
    ckv = torch.randn((3, S, m.kv_lora_rank), generator=g)
    kr = torch.randn((3, S, m.rope_head_dim), generator=g)
    before = (ckv.clone(), kr.clone())
    lens = torch.tensor([5, 0, 1], dtype=torch.int32)
    y = TL.mla_decode(tp, tcfg, torch.randn((3, 1, tcfg.d_model),
                                            generator=g), ckv, kr, lens)
    assert bool(torch.isfinite(y).all())
    for t, t0 in zip((ckv, kr), before):
        changed = (t != t0).any(dim=-1)
        want = torch.zeros((3, S), dtype=torch.bool)
        want[0, 4] = want[1, 0] = want[2, 0] = True
        assert torch.equal(changed, want)
    # the free row's output is that of a one-token context
    alone = TL.mla_decode(tp, tcfg, torch.zeros((1, 1, tcfg.d_model)),
                          ckv[1:2].clone(), kr[1:2].clone(),
                          torch.tensor([1], dtype=torch.int32))
    zero = TL.mla_decode(tp, tcfg, torch.zeros((3, 1, tcfg.d_model)),
                         ckv.clone(), kr.clone(), lens)
    torch.testing.assert_close(zero[1:2], alone, rtol=1e-6, atol=1e-6)


def test_latent_cache_layout_and_write():
    cfg = reduce_config(get_config(ARCH), layers_per_stage=2)
    n = cfg.num_layers                    # every layer of deepseek is MLA
    cache = LatentCache(cfg, 4, 24, dtype=torch.float32, device="cpu")
    m = cfg.mla
    assert tuple(cache.ckv.shape) == (n, 4, 24, m.kv_lora_rank)
    assert tuple(cache.kr.shape) == (n, 4, 24, m.rope_head_dim)
    states = [(torch.full((9, m.kv_lora_rank), float(i)),
               torch.full((9, m.rope_head_dim), -float(i))) for i in range(n)]
    cache.write(2, states)
    for i in range(n):
        assert bool((cache.ckv[i, 2, :9] == i).all())
        assert bool((cache.kr[i, 2, :9] == -i).all())
    assert not cache.ckv[:, :2].any() and not cache.ckv[:, 2, 9:].any()
    assert cache.decode_view()["ckv"] is cache.ckv
    with pytest.raises(ValueError):
        cache.write(0, states[:-1])
    with pytest.raises(ValueError):
        cache.write(0, [(torch.zeros((25, m.kv_lora_rank)),
                         torch.zeros((25, m.rope_head_dim)))] * n)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            LatentCache(cfg, 2, 8)


def test_full_width_latent_cache_bytes():
    """27 MLA layers x 8 slots x 4096 rows x (512 + 64) bf16 values."""
    cfg = get_config(ARCH)
    n = sum(b.mixer == "mla" for b in cfg.layer_list())
    m = cfg.mla
    assert n * 8 * 4096 * (m.kv_lora_rank + m.rope_head_dim) * 2 == \
        1_019_215_872
