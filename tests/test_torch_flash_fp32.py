"""Flash attention in fp32 at head dims 16-128, where the card runs the
split-TF32 route (``flash_tf32x3_kernel``): each fp32 product as three
TF32 tensor-core products, lo.hi + hi.lo + hi.hi, with every operand split
into a TF32 high part and the TF32-rounded rest.

The card cannot run here, so its arithmetic is emulated below (test code
only; the package's plain version stays ``attention_ref``): TF32 rounding
by bit masking, as ``cvt.rna.tf32.f32`` rounds (to nearest, ties away from
zero), the products in 8-wide k-steps in the kernel's order, P split like
Q and K, and the online softmax over 64-key tiles.  The emulation is held
to the JAX package's plain version and to the Pallas kernel (interpret
mode, as the JAX package's own tests run it, where its block-multiple
lengths allow) on every fp32 shape of ``chip_smoke.FLASH_BRANCHES`` that
takes the route, and the CPU wrapper is held to JAX on the same shapes.
Tolerances: 2e-5, those of ``tests/test_kernels.py`` for fp32; 1e-4, the
card's fp32 tolerance, on the shapes with q and k scaled by 4, where the
peaked softmax takes fp32 itself to ~3e-5 of float64.  A guard shows that
the tolerance tells the routes apart: one TF32 product breaks it there."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import \
    flash_attention as pallas_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jax_attn  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402

TOL = 2e-5
TOL_PEAKED = 1e-4      # the card's fp32 tolerance (chip_smoke.TOL)
KEY_TILE = 64          # keys per tile of the kernel's online softmax


def _chip_smoke():
    """``chip_smoke.py`` as a module: it imports only the standard library
    at its top, so loading it costs nothing and touches no card."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
FP32_BRANCHES = [s for s in CS.FLASH_BRANCHES
                 if s[6] == "float32" and CS.flash_route(s[6], s[5])
                 == "tf32x3"]


def _id(s):
    return "-".join([f"B{s[0]}", f"{s[1]}x{s[2]}", f"H{s[3]}", f"KV{s[4]}",
                     f"hd{s[5]}"] + [f"{k}{v}" for k, v in s[7].items()]
                    + ([f"buf{s[8]}"] if s[8] else []))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(shape, seed):
    """q, k, v of a branch shape as torch tensors and JAX arrays holding
    the same numbers, q and k scaled by the shape's ``qk_scale``.  With a
    buffer length the torch k/v are the prefix ``buf[:, :Lk]`` of a longer
    buffer whose tail is NaN, as the card's check passes them."""
    B, Lq, Lk, H, KV, hd, _, kw, buf_len = shape
    scale = kw.get("qk_scale", 1.0)
    rng = np.random.default_rng(seed)
    S = buf_len or Lk
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Lq, H, hd), (B, S, KV, hd), (B, S, KV, hd))]
    arrs[0] *= scale
    arrs[1] *= scale
    for a in arrs[1:]:
        a[:, Lk:] = np.nan
    ts = [torch.from_numpy(a) for a in arrs]
    ts[1], ts[2] = ts[1][:, :Lk], ts[2][:, :Lk]
    js = [jnp.asarray(t.numpy()) for t in ts]
    return ts, js


def _attn_kw(kw):
    return {k: v for k, v in kw.items() if k != "qk_scale"}


def tf32(x):
    """x rounded to TF32 (10 mantissa bits): to nearest, ties away from
    zero, by adding half of the dropped 13 bits' unit and masking them."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    return ((bits + 0x1000) & 0xFFFFE000).to(torch.int32).view(torch.float32)


def _split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def _mm(acc, a, b, products):
    """acc + a @ b over the last axis of a in k-steps of 8, each step's
    products added in the kernel's order into one fp32 accumulator:
    lo.hi, hi.lo, hi.hi (``products`` 3), or hi.hi alone (1: plain TF32)."""
    ahi, alo = _split(a)
    bhi, blo = _split(b)
    for k0 in range(0, a.shape[-1], 8):
        sa, sb = (..., slice(k0, k0 + 8)), (..., slice(k0, k0 + 8), slice(None))
        if products == 3:
            acc = acc + alo[sa] @ bhi[sb]
            acc = acc + ahi[sa] @ blo[sb]
        acc = acc + ahi[sa] @ bhi[sb]
    return acc


def emulate(q, k, v, *, causal=True, window=None, softcap=None, products=3):
    """The split-TF32 kernel's arithmetic on the CPU, in fp32: per 64-key
    tile S = Q K^T from zero, softcap, masks, the running max and sum, O
    rescaled and P V added onto it; O / max(l, 1e-30) at the end."""
    B, Lq, H, hd = q.shape
    Lk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qh = q.permute(0, 2, 1, 3)                                  # [B, H, Lq, hd]
    kh = k.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)     # [B, H, Lk, hd]
    vh = v.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    scale = hd ** -0.5
    qi = torch.arange(Lq)[:, None] + (Lk - Lq)
    m = torch.full((B, H, Lq, 1), -torch.inf)
    l = torch.zeros((B, H, Lq, 1))
    o = torch.zeros((B, H, Lq, hd))
    for kt in range(0, Lk, KEY_TILE):
        ke = min(kt + KEY_TILE, Lk)
        s = _mm(torch.zeros((B, H, Lq, ke - kt)), qh,
                kh[:, :, kt:ke].transpose(-1, -2), products)
        s = s * scale
        if softcap is not None:
            s = torch.tanh(s / softcap) * softcap
        ki = torch.arange(kt, ke)[None]
        ok = torch.ones((Lq, ke - kt), dtype=torch.bool)
        if causal:
            ok &= ki <= qi
        if window is not None:
            ok &= ki > qi - window
        s = s.masked_fill(~ok, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        m_use = torch.where(m_new == -torch.inf, 0.0, m_new)
        alpha = torch.exp(m - m_use)
        p = torch.exp(s - m_use)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = _mm(o * alpha, p, vh[:, :, kt:ke], products)
        m = m_new
    return (o / l.clamp_min(1e-30)).permute(0, 2, 1, 3)


def _close(out, ref, tol):
    np.testing.assert_allclose(np.asarray(out, np.float32),
                               np.asarray(ref, np.float32), rtol=tol, atol=tol)


def _tol(shape):
    return TOL_PEAKED if shape[7].get("qk_scale", 1.0) != 1.0 else TOL


@pytest.mark.parametrize("shape", FP32_BRANCHES, ids=map(_id, FP32_BRANCHES))
def test_split_tf32_emulation_matches_jax(shape):
    (q, k, v), (jq, jk, jv) = _inputs(shape, seed=shape[1] + shape[2])
    kw = _attn_kw(shape[7])
    out = emulate(q, k, v, **kw)
    assert torch.isfinite(out).all()
    _close(out, jax_attn(jq, jk, jv, **kw), _tol(shape))


PALLAS_BRANCHES = [s for s in FP32_BRANCHES
                   if all(n <= 128 or n % 128 == 0 for n in s[1:3])]


@pytest.mark.parametrize("shape", PALLAS_BRANCHES,
                         ids=map(_id, PALLAS_BRANCHES))
def test_split_tf32_emulation_matches_pallas_kernel(shape):
    (q, k, v), (jq, jk, jv) = _inputs(shape, seed=shape[1] + shape[2])
    kw = _attn_kw(shape[7])
    _close(emulate(q, k, v, **kw), pallas_flash(jq, jk, jv, **kw),
           _tol(shape))


PEAKED = [s for s in FP32_BRANCHES if s[7].get("qk_scale", 1.0) == 4.0]


@pytest.mark.parametrize("shape", PEAKED, ids=map(_id, PEAKED))
def test_one_tf32_product_breaks_the_tolerance_three_do_not(shape):
    """With q and k scaled by 4 the scores are 16 times larger, and one
    TF32 product's error (2^-11 of each operand) moves the peaked softmax
    past 1e-4; three products stay inside it."""
    (q, k, v), (jq, jk, jv) = _inputs(shape, seed=shape[1] + shape[2])
    ref = np.asarray(jax_attn(jq, jk, jv, **_attn_kw(shape[7])))
    err = {n: np.abs(emulate(q, k, v, products=n).numpy() - ref).max()
           for n in (1, 3)}
    assert err[1] > TOL_PEAKED and err[3] <= TOL_PEAKED, err


@pytest.mark.parametrize("shape", FP32_BRANCHES, ids=map(_id, FP32_BRANCHES))
def test_cpu_wrapper_matches_jax_on_fp32_branches(shape):
    (q, k, v), (jq, jk, jv) = _inputs(shape, seed=shape[1] + shape[2])
    kw = _attn_kw(shape[7])
    out = flash_attention(q, k, v, **kw)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    _close(out, jax_attn(jq, jk, jv, **kw), _tol(shape))


def test_card_branches_reach_the_fp32_route():
    """The fp32 shapes the card's check runs on the split-TF32 route cover
    what it must handle, at hd 64 and 128 (and the reduced configs' 16
    and 32): groupings 1, 4, 5 and 8, ragged edges, a chunk, Lq below 64,
    windows of 40 and of less than a key tile, softcap, non-causal with
    and without a window, B = 2 prefixes of a longer buffer and peaked
    scores; fp32 at the other head dims stays on the FMA kernel."""
    S = FP32_BRANCHES
    assert {s[5] for s in S} == {16, 32, 64, 128}
    assert {s[3] // s[4] for s in S} >= {1, 4, 5, 8}
    assert any(s[1] % 64 and s[1] == s[2] for s in S)
    assert any(s[1] < s[2] for s in S)
    assert any(s[1] < 64 for s in S)
    windows = {s[7].get("window") for s in S}
    assert 40 in windows and any(w and w < KEY_TILE for w in windows)
    assert any("softcap" in s[7] for s in S)
    assert any(s[7].get("causal") is False and "window" in s[7] for s in S)
    assert any(s[7].get("causal") is False and "window" not in s[7]
               for s in S)
    assert any(s[0] == 2 and s[8] for s in S)
    assert {s[5] for s in PEAKED} == {64, 128}
    assert all(CS.flash_route("float32", hd) == "fma"
               for hd in (48, 80, 96, 112, 256))
    assert {s[5] for s in CS.FLASH_BRANCHES
            if s[6] == "float32" and s not in S} >= {96, 256}
