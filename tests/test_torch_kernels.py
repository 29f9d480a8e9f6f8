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


# -- the two-pass CUDA paged kernel: host partition and merge arithmetic ------

@pytest.mark.parametrize(
    "B,KV,n_pages,page,sms",
    [(1, 8, 256, 16, 132),     # llama B=1 at 4096 slots: many splits
     (8, 8, 256, 16, 132),     # llama B=8 at 4096 slots
     (8, 8, 65, 16, 132),      # the decode profile's table (ctx ~1025)
     (64, 8, 256, 16, 132),    # a batch that fills the card unsplit
     (1, 8, 1, 16, 132),       # one page: shorter than a tile
     (1, 1, 4096, 8, 132),     # G = 8 heads on one KV head, long table
     (3, 2, 5, 32, 132),
     (2, 8, 1, 8, 1),
     (16, 4, 7, 16, 114),
     (1, 8, 1000, 16, 132),    # slots not a multiple of the tile
     (4, 8, 33, 32, 78)])
def test_paged_partition_covers_the_table(B, KV, n_pages, page, sms):
    from repro_torch.kernels.paged_attention.ops import (MIN_SPLIT_TILES,
                                                         TILE, partition)
    splits, split_tokens = partition(B, KV, n_pages, page, sms)
    n_tokens = n_pages * page
    assert splits >= 1
    assert split_tokens > 0 and split_tokens % TILE == 0   # whole tiles
    assert splits * split_tokens >= n_tokens               # covers the table
    assert (splits - 1) * split_tokens < n_tokens          # none wholly past
    tiles = -(-n_tokens // TILE)
    assert split_tokens >= TILE * min(MIN_SPLIT_TILES, tiles)
    assert splits == 1 or B * KV * (splits - 1) < 2 * sms  # ~2 blocks per SM


# Which group of a pass-1 block keeps the softmax of the token at position
# pos (splits start at multiples of 64): bf16, warp j of 4 takes 16
# consecutive tokens of each 64-token tile; fp32, half-warp j of 8 takes the
# tokens pos % 8 == j of each 32-token sub-tile.
GROUPS = {"bfloat16": (4, lambda pos: (pos % 64) // 16),
          "float32": (8, lambda pos: pos % 8)}


def _split_partials(q, kp, vp, bt, ctx, split_tokens, n_split, groups):
    """Pass 1 of the CUDA paged kernel in plain arithmetic: per (sequence,
    KV head, split) the m (log2 units), l and unnormalised acc of its G
    query rows.  Inside a split each group keeps a softmax over its tokens
    (``GROUPS``); the groups merge at the split's end.  A split wholly past
    ctx gives m = -inf, l = 0 and an acc that is never written (NaN here,
    so that a merge that read it would fail)."""
    B, H, hd = q.shape
    page, KV = kp.shape[1], kp.shape[2]
    G = H // KV
    n_groups, group_of = GROUPS[groups]
    c = 1.4426950408889634 / hd ** 0.5
    m = torch.full((B, KV, n_split, G), float("-inf"))
    l = torch.zeros((B, KV, n_split, G))
    acc = torch.full((B, KV, n_split, G, hd), float("nan"))
    for b in range(B):
        for s in range(n_split):
            start = s * split_tokens
            end = min(start + split_tokens, int(ctx[b]))
            if start >= end:
                continue
            pos = torch.arange(start, end)
            rows = torch.from_numpy(bt[b]).long()[pos // page]
            k = kp[rows, pos % page].float()          # [n, KV, hd]
            v = vp[rows, pos % page].float()
            for h in range(KV):
                sc = (q[b, h * G:(h + 1) * G].float() * c) @ k[:, h].T
                ms, ls, accs = [], [], []
                for j in range(n_groups):
                    sel = group_of(pos) == j
                    if not sel.any():
                        ms.append(torch.full((G,), float("-inf")))
                        ls.append(torch.zeros(G))
                        accs.append(torch.zeros(G, hd))
                        continue
                    mj = sc[:, sel].max(dim=1).values
                    p = torch.exp2(sc[:, sel] - mj[:, None])
                    ms.append(mj)
                    ls.append(p.sum(1))
                    accs.append(p @ v[sel, h])
                ms, ls, accs = torch.stack(ms), torch.stack(ls), torch.stack(accs)
                mb = ms.max(dim=0).values      # finite: group 0 has a token
                w = torch.exp2(ms - mb)        # 0 for a group with none
                m[b, h, s] = mb
                l[b, h, s] = (w * ls).sum(0)
                acc[b, h, s] = (w[..., None] * accs).sum(0)
    return m, l, acc


def _merge_splits(m, l, acc, ctx, split_tokens):
    """Pass 2 of the CUDA paged kernel: over the ceil(ctx / split_tokens)
    splits that hold tokens, o = sum_s 2^(m_s - m*) acc_s / sum_s
    2^(m_s - m*) l_s; zeros when there are none.  It never reads an empty
    split's m or acc, so it never forms -inf - (-inf)."""
    B, KV, S, G, hd = acc.shape
    out = torch.zeros(B, KV, G, hd)
    for b in range(B):
        n_act = -(-int(ctx[b]) // split_tokens)
        if n_act == 0:
            continue
        ms, ls, accs = m[b, :, :n_act], l[b, :, :n_act], acc[b, :, :n_act]
        assert torch.isfinite(ms).all()
        w = torch.exp2(ms - ms.max(dim=1, keepdim=True).values)  # [KV, s, G]
        out[b] = ((w[..., None] * accs).sum(1)
                  / (w * ls).sum(1)[..., None])
    return out.reshape(B, KV * G, hd)


@pytest.mark.parametrize("groups", sorted(GROUPS))
@pytest.mark.parametrize("ctx,split_tokens", [
    ([0, 0], 64),                      # every split empty: zeros, no NaN
    ([1, 2], 64),                      # one token: three empty splits
    ([8, 9], 64),                      # a page boundary (page 8)
    ([63, 64, 65], 64),                # either side of a split boundary
    ([100, 256], 64),                  # rows with empty splits; a full row
    ([0, 255, 257, 1024], None),       # the split that partition() picks
])
def test_split_merge_matches_plain_paged(ctx, split_tokens, groups):
    from repro_torch.kernels.paged_attention.ops import partition
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    npg, page, KV = (32, 8, 2) if split_tokens else (128, 8, 2)
    B = len(ctx)
    (q, _), (kp, _), (vp, _), bt, ctx = _paged_inputs(
        B, 8, KV, 32, page, npg, 64, "float32", seed=7, ctx=ctx)
    if split_tokens is None:
        n_split, split_tokens = partition(B, KV, npg, page, 132)
        assert n_split > 1
    n_split = -(-npg * page // split_tokens)
    parts = _split_partials(q, kp, vp, bt, ctx, split_tokens, n_split, groups)
    out = _merge_splits(*parts, ctx, split_tokens)
    ref = paged_attention_ref(q, kp, vp, torch.from_numpy(bt),
                              torch.from_numpy(ctx))
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-5, atol=2e-5)
    for b in np.flatnonzero(ctx == 0):
        assert not out[b].any()                 # ctx = 0 -> exact zeros


def test_split_merge_matches_pallas_kernel():
    from repro.kernels.paged_attention.ops import paged_attention as pallas
    (q, jq), (kp, jkp), (vp, jvp), bt, ctx = _paged_inputs(
        3, 8, 2, 32, 8, 20, 64, "float32", seed=6, ctx=[0, 20, 150])
    parts = _split_partials(q, kp, vp, bt, ctx, 64, 3, "bfloat16")
    out = _merge_splits(*parts, ctx, 64)
    ref = pallas(jq, jkp, jvp, jnp.asarray(bt), jnp.asarray(ctx))
    np.testing.assert_allclose(out.numpy(), _f32(ref), rtol=2e-5, atol=2e-5)
    assert not out[0].any()


def test_paged_wrapper_rejects_groups_past_eight():
    q = torch.zeros(1, 16, 32)
    kp = torch.zeros(4, 8, 1, 32)
    with pytest.raises(ValueError):
        paged_attention(q, kp, kp.clone(), torch.zeros(1, 2, dtype=torch.int32),
                        torch.ones(1, dtype=torch.int32))
