"""Flash attention at head dim 256 (gemma3-12b's prefill), where the card
runs the 384-thread ``wgmma`` route.  On the CPU the wrapper runs the plain
version, which is also the card's oracle: here it is held to the real
Pallas kernel (interpret mode, as the JAX package's own tests run it) and
to the JAX package's plain version on every bf16 hd-256 shape of
``chip_smoke.FLASH_BRANCHES``, the shapes the card's check judges.
Tolerances are those of ``tests/test_kernels.py``: fp32 2e-5, bf16 2e-2."""
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

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _chip_smoke():
    """``chip_smoke.py`` as a module: it imports only the standard library
    at its top, so loading it costs nothing and touches no card."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


HD256_BRANCHES = [s for s in _chip_smoke().FLASH_BRANCHES
                  if s[5] == 256 and s[6] == "bfloat16"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, Lq, Lk, H, KV, name, seed, buf_len=None):
    """q, k, v as torch tensors and JAX arrays holding the same numbers.
    With ``buf_len`` the torch k/v are the prefix ``buf[:, :Lk]`` of a
    longer buffer whose tail is NaN, as the card's check passes them."""
    tdt, jdt = DTYPES[name]
    rng = np.random.default_rng(seed)
    S = buf_len or Lk
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Lq, H, 256), (B, S, KV, 256), (B, S, KV, 256))]
    for a in arrs[1:]:
        a[:, Lk:] = np.nan
    ts = [torch.from_numpy(a).to(tdt) for a in arrs]
    ts[1], ts[2] = ts[1][:, :Lk], ts[2][:, :Lk]
    js = [jnp.asarray(t.float().numpy()).astype(jdt) for t in ts]
    return ts, js


def _close(out, ref, name):
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=TOL[name], atol=TOL[name])


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("Lq,Lk", [(128, 256), (256, 256)])
@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("G", [1, 2])
def test_plain_flash_hd256_matches_pallas_kernel(name, Lq, Lk, window, G):
    (q, k, v), (jq, jk, jv) = _inputs(1, Lq, Lk, 2 * G, 2, name,
                                      seed=Lq + G + (window or 0))
    out = flash_attention(q, k, v, window=window)
    ref = pallas_flash(jq, jk, jv, window=window)
    _close(out, ref, name)


@pytest.mark.parametrize(
    "shape", HD256_BRANCHES,
    ids=["-".join([f"B{s[0]}", f"{s[1]}x{s[2]}", f"H{s[3]}", f"KV{s[4]}"]
                  + [f"{k}{v}" for k, v in s[7].items()]
                  + ([f"buf{s[8]}"] if s[8] else []))
         for s in HD256_BRANCHES])
def test_plain_flash_hd256_matches_jax_on_card_branches(shape):
    B, Lq, Lk, H, KV, hd, name, kw, buf_len = shape
    (q, k, v), (jq, jk, jv) = _inputs(B, Lq, Lk, H, KV, name, seed=Lq + Lk,
                                      buf_len=buf_len)
    out = flash_attention(q, k, v, **kw)
    ref = jax_attn(jq, jk, jv, **kw)
    assert torch.isfinite(out).all()
    _close(out, ref, name)


def test_card_branches_reach_the_hd256_route():
    """The shapes the card's check runs at hd 256 in bf16 cover what the
    route must handle: groupings 1, 2 and 8, a q tile that is partly
    empty and one consumer with no live row, a window inside one key
    tile and gemma3's 1024, non-causal, softcap, a chunk, a prefix of a
    longer buffer and B = 2."""
    cs = _chip_smoke()
    assert all(cs.flash_route(s[6], s[5]) == "wgmma"
               for s in HD256_BRANCHES)
    assert cs.flash_route("float32", 256) == "fma"
    assert {s[3] // s[4] for s in HD256_BRANCHES} >= {1, 2, 8}
    assert any(s[1] % 128 for s in HD256_BRANCHES)
    assert any(s[1] < 64 for s in HD256_BRANCHES)
    windows = {s[7].get("window") for s in HD256_BRANCHES}
    assert 1024 in windows and any(w and w < 64 for w in windows)
    assert any(s[7].get("causal") is False for s in HD256_BRANCHES)
    assert any("softcap" in s[7] for s in HD256_BRANCHES)
    assert any(s[1] < s[2] for s in HD256_BRANCHES)
    assert any(s[8] for s in HD256_BRANCHES)
    assert any(s[0] == 2 for s in HD256_BRANCHES)
