"""The plain versions of the port's two kernels against the JAX oracles,
and one case each against the real Pallas kernel (interpret mode on the
CPU).  On the CPU the ``ops`` wrappers run these plain versions; the CUDA
kernels are held to them on the card by ``chip_smoke.py``.  Tolerances are
those of ``tests/test_kernels.py``: fp32 2e-5, bf16 2e-2."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ref import attention_ref as jax_attn  # noqa: E402
from repro.kernels.paged_attention.ref import \
    paged_attention_ref as jax_paged  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.paged_attention.ops import paged_attention  # noqa: E402

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _pair(a, name):
    """The same numbers as a torch tensor and a JAX array of one dtype."""
    tdt, jdt = DTYPES[name]
    t = torch.from_numpy(a).to(tdt)
    return t, jnp.asarray(t.float().numpy()).astype(jdt)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _attn_inputs(B, Lq, Lk, H, KV, hd, name, seed=0):
    rng = np.random.default_rng(seed)
    return [_pair(rng.standard_normal(s).astype(np.float32), name)
            for s in ((B, Lq, H, hd), (B, Lk, KV, hd), (B, Lk, KV, hd))]


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize(
    "B,Lq,Lk,H,KV,hd,window",
    [(2, 256, 256, 4, 2, 64, None),
     (1, 128, 384, 8, 8, 128, None),
     (2, 256, 256, 4, 4, 64, 96),
     (1, 512, 512, 2, 1, 128, 128),
     (2, 17, 17, 4, 1, 16, None),        # ragged: no block multiple
     (1, 9, 25, 4, 2, 32, None),         # a chunk over its staged prefix
     (1, 300, 300, 4, 2, 16, 40)])
def test_plain_flash_matches_jax_oracle(B, Lq, Lk, H, KV, hd, window, name):
    (q, jq), (k, jk), (v, jv) = _attn_inputs(B, Lq, Lk, H, KV, hd, name)
    out = flash_attention(q, k, v, window=window)
    ref = jax_attn(jq, jk, jv, window=window)
    np.testing.assert_allclose(_f32(out), _f32(ref), **_tol(name))


@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_softcap(causal):
    (q, jq), (k, jk), (v, jv) = _attn_inputs(1, 40, 72, 4, 2, 64, "float32")
    out = flash_attention(q, k, v, causal=causal, softcap=30.0)
    ref = jax_attn(jq, jk, jv, causal=causal, softcap=30.0)
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_plain_flash_reads_a_prefix_of_a_longer_buffer(name):
    """``attn_chunk`` passes k/v as ``buf[:, :n]`` of a longer staging
    buffer: the batch stride is the buffer's, and rows past n hold stale
    values (NaN here) that must not reach the output.  The CUDA kernels'
    tensor maps take their L extent and batch stride from this layout."""
    B, Lq, n, S, H, KV, hd = 2, 24, 72, 120, 4, 2, 64
    rng = np.random.default_rng(3)
    tdt, _ = DTYPES[name]
    q, jq = _pair(rng.standard_normal((B, Lq, H, hd)).astype(np.float32), name)
    bufs = []
    for _ in range(2):
        buf = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
        buf[:, n:] = np.nan
        bufs.append(torch.from_numpy(buf).to(tdt))
    k, v = (b[:, :n] for b in bufs)
    assert k.stride(0) == S * KV * hd and not k.is_contiguous()
    out = flash_attention(q, k, v)
    jk, jv = (jnp.asarray(t.float().numpy()).astype(DTYPES[name][1])
              for t in (k, v))
    ref = jax_attn(jq, jk, jv)
    assert np.isfinite(_f32(out)).all()
    np.testing.assert_allclose(_f32(out), _f32(ref), **_tol(name))


def _paged_inputs(B, H, KV, hd, page, npg, P, name, seed=0, ctx=None):
    rng = np.random.default_rng(seed)
    q = _pair(rng.standard_normal((B, H, hd)).astype(np.float32), name)
    kp = _pair(rng.standard_normal((P, page, KV, hd)).astype(np.float32), name)
    vp = _pair(rng.standard_normal((P, page, KV, hd)).astype(np.float32), name)
    bt = rng.integers(0, P, (B, npg)).astype(np.int32)
    if ctx is None:
        ctx = rng.integers(1, npg * page + 1, B)
    ctx = np.asarray(ctx, np.int32)
    return q, kp, vp, bt, ctx


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize(
    "B,H,KV,hd,page,npg,P",
    [(4, 8, 2, 64, 16, 8, 64),
     (2, 4, 4, 128, 32, 4, 16),
     (3, 16, 8, 64, 16, 6, 32),
     (3, 8, 4, 64, 16, 5, 32),           # the tiling sweep's ragged tail
     (3, 8, 4, 64, 16, 8, 32)])
def test_plain_paged_matches_jax_oracle(B, H, KV, hd, page, npg, P, name):
    (q, jq), (kp, jkp), (vp, jvp), bt, ctx = _paged_inputs(
        B, H, KV, hd, page, npg, P, name)
    out = paged_attention(q, kp, vp, torch.from_numpy(bt),
                          torch.from_numpy(ctx))
    ref = jax_paged(jq, jkp, jvp, jnp.asarray(bt), jnp.asarray(ctx))
    np.testing.assert_allclose(_f32(out), _f32(ref), **_tol(name))


def test_plain_flash_matches_pallas_kernel():
    from repro.kernels.flash_attention.ops import flash_attention as pallas
    (q, jq), (k, jk), (v, jv) = _attn_inputs(1, 128, 256, 4, 2, 32,
                                             "float32", seed=5)
    out = flash_attention(q, k, v, window=100)
    ref = pallas(jq, jk, jv, window=100)
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=2e-5, atol=2e-5)


def test_plain_paged_matches_pallas_kernel_with_empty_context():
    from repro.kernels.paged_attention.ops import paged_attention as pallas
    (q, jq), (kp, jkp), (vp, jvp), bt, ctx = _paged_inputs(
        3, 8, 2, 32, 8, 5, 16, "float32", seed=6, ctx=[0, 20, 37])
    out = paged_attention(q, kp, vp, torch.from_numpy(bt),
                          torch.from_numpy(ctx))
    ref = pallas(jq, jkp, jvp, jnp.asarray(bt), jnp.asarray(ctx))
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=2e-5, atol=2e-5)
    assert not _f32(out)[0].any()          # ctx = 0 -> zeros, as Pallas


@pytest.mark.parametrize("bad", ["hd", "lq", "dtype", "window"])
def test_flash_wrapper_rejects_bad_input(bad):
    q = torch.zeros(1, 8, 4, 32)
    k = torch.zeros(1, 8, 2, 32)
    kw = {}
    if bad == "hd":
        q, k = torch.zeros(1, 8, 4, 24), torch.zeros(1, 8, 2, 24)
    elif bad == "lq":
        q = torch.zeros(1, 9, 4, 32)
    elif bad == "dtype":
        q = q.half()
    else:
        kw = {"window": 0}
    with pytest.raises((ValueError, TypeError)):
        flash_attention(q, k, k.clone(), **kw)
