"""Window mixers of the port against the JAX package on bridged fp32
weights: the per-slot ring (``engine/window_cache.py``) against
``_to_ring`` and ``ring_convert_cache``, window decode over the ring
through the paged kernel's plain version against ``attn_decode`` over the
JAX ring, ``decode_step`` of reduced gemma3-27b (5 window layers and a
full one, then 2 window layers; window 16) across the ring's wrap, and the
engine's greedy tokens for reduced gemma3-27b, gemma3-12b and
mixtral-8x22b, one-shot and chunked.  Plus a slot reused after a longer
request, a free row's writes, window layers of two sizes (16 and 8: one
ring stack each, their bytes, prefill into them, decode steps and engine
tokens across both wraps), and the plain paged and flash kernels at
gemma3-12b's head dim 256.  Tolerances: 1e-4
for fp32 logits and layer outputs (the frameworks order their sums
differently), exact for greedy tokens and ring contents, and the kernel
tests' 2e-5 (fp32) and 2e-2 (bf16) for the plain kernels."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduce_config as jax_reduce  # noqa: E402
from repro.engine.engine import EngineRequest as JReq  # noqa: E402
from repro.engine.engine import InferenceEngine as JEngine  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jax_attn  # noqa: E402
from repro.kernels.paged_attention.ref import \
    paged_attention_ref as jax_paged  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import base as port_base  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.engine.engine import EngineRequest, InferenceEngine  # noqa: E402
from repro_torch.engine.kv_cache import PagedKVCache  # noqa: E402
from repro_torch.engine.window_cache import WindowCache  # noqa: E402
from repro_torch.launch.serve import alternate_windows  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.paged_attention.ops import paged_attention  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
WINDOW = 16                      # reduce_config's window
MIXTRAL_8_LAYERS = 20_435_140_608    # mixtral-8x22b cut to 8 of 56 layers
ARCHS = ["gemma3-27b", "gemma3-12b", "mixtral-8x22b"]
# mixtral's one stage at two layers; gemma3's two stages (5 window + 1
# full, then the 2 trailing window layers) at one repeat each
LAYERS_PER_STAGE = {"gemma3-27b": 1, "gemma3-12b": 1, "mixtral-8x22b": 2}


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


@functools.lru_cache(maxsize=None)
def _bridged(arch):
    lps = LAYERS_PER_STAGE[arch]
    jcfg = jax_reduce(jax_get_config(arch), layers_per_stage=lps)
    tcfg = reduce_config(get_config(arch), layers_per_stage=lps)
    params = JM.init_params(jcfg, jax.random.PRNGKey(4), dtype=jnp.float32)
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                            device="cpu")
    return jcfg, tcfg, params, model


def _one_window_layer(cfg):
    return dataclasses.replace(
        cfg, num_layers=1,
        stages=port_base.uniform_stage(1, "window", window=WINDOW))


def _ring_rows(cache: WindowCache, layer: int, slot: int):
    """(k, v) [S, KV, hd]: ring rows 0..S-1 of ``slot`` in ``layer`` of a
    cache of one ring size."""
    (ring,) = cache.stacks
    n, page = ring.pages_per_slot, ring.page_size
    return tuple(t[layer, slot * n:(slot + 1) * n].reshape(
        n * page, *t.shape[3:])[:ring.size] for t in (ring.k, ring.v))


def _jax_layers(jcfg):
    """(stage, pattern slot, repeat) of every layer in ``layer_list`` order:
    where each layer's cache sits in the JAX tree."""
    return [(si, pi, r) for si, st in enumerate(jcfg.stages)
            for r in range(st.repeat) for pi in range(len(st.pattern))]


def test_reduced_configs_keep_their_windows():
    for arch in ARCHS:
        _, tcfg, _, model = _bridged(arch)
        kinds = [k for k, _ in TM.layer_caches(tcfg)]
        want = {"gemma3-27b": ["win"] * 5 + ["kv"] + ["win"] * 2,
                "gemma3-12b": ["win"] * 5 + ["kv"],      # 48 = 8 x 6
                "mixtral-8x22b": ["win"] * 2}[arch]
        assert kinds == want
        assert {b.window for b in tcfg.layer_list()
                if b.mixer == "window"} == {WINDOW}
        assert all(blk.parts[0] == "attn" for blk in model.layers)


@pytest.mark.parametrize("L,max_len,page", [(5, 64, 4), (16, 64, 4),
                                            (37, 64, 4), (37, 64, 16),
                                            (29, 12, 4), (29, 12, 5)])
def test_prefill_into_the_ring_matches_to_ring(L, max_len, page):
    """``WindowCache.write`` puts the last min(L, S) rows at t % S, as
    ``_to_ring`` does, S = min(window, max_len); other slots untouched,
    rows past S (S = 12 over pages of 5) never written."""
    cfg = _one_window_layer(reduce_config(get_config("gemma3-27b")))
    cache = WindowCache(cfg, 3, max_len, page, dtype=torch.float32,
                        device="cpu")
    S = min(WINDOW, max_len)
    (ring,) = cache.stacks
    assert ring.size == S and ring.pages_per_slot == -(-S // page)
    assert torch.equal(ring.tables, torch.arange(
        3 * ring.pages_per_slot, dtype=torch.int32).view(3, -1))
    rng = np.random.default_rng(L)
    k = rng.standard_normal((1, L, 1, 16)).astype(np.float32)
    v = rng.standard_normal((1, L, 1, 16)).astype(np.float32)
    cache.write(1, [(torch.from_numpy(k[0]), torch.from_numpy(v[0]))])
    got_k, got_v = _ring_rows(cache, 0, 1)
    np.testing.assert_array_equal(_np(got_k), np.asarray(
        JM._to_ring(jnp.asarray(k), S))[0])
    np.testing.assert_array_equal(_np(got_v), np.asarray(
        JM._to_ring(jnp.asarray(v), S))[0])
    n = ring.pages_per_slot
    assert not ring.k[0, :n].any() and not ring.k[0, 2 * n:].any()
    assert not ring.k[0, n:2 * n].reshape(-1, 1, 16)[S:].any()


def test_window_decode_matches_jax_across_the_wrap():
    """Three rows prefilled to 5, 14 and 30 tokens, then six decode steps:
    the second row wraps at 16, the third has wrapped already.  The JAX
    layer writes and masks its dense ring; the port writes its paged ring
    and the paged kernel reads min(ctx, S) rows."""
    jcfg = jax_reduce(jax_get_config("gemma3-27b"))
    tcfg = reduce_config(get_config("gemma3-27b"))
    jp = JL.init_attention(jax.random.PRNGKey(2), jcfg, jnp.float32)
    tp = TL.frozen({k: torch.from_numpy(np.array(a)) for k, a in jp.items()})
    lens = [5, 14, 30]
    # pages of 5: the ring's 16 rows over 4 pages leave rows 16..19 unused,
    # so the kernel must be told min(ctx, 16), not the table's 20 rows
    cache = WindowCache(_one_window_layer(tcfg), 3, 64, 5,
                        dtype=torch.float32, device="cpu")
    S = cache.stacks[0].size
    rng = np.random.default_rng(0)
    jk, jv = [], []
    for slot, n in enumerate(lens):
        x = rng.standard_normal((1, n, tcfg.d_model)).astype(np.float32)
        _, (k, v) = JL.attn_forward(jp, jcfg, jnp.asarray(x),
                                    jnp.arange(n)[None], WINDOW)
        jk.append(JM._to_ring(k, S)[0])
        jv.append(JM._to_ring(v, S)[0])
        cache.write(slot, [(torch.from_numpy(np.array(k[0])),
                            torch.from_numpy(np.array(v[0])))])
    jk, jv = jnp.stack(jk), jnp.stack(jv)
    pos = np.array(lens, np.int32)
    (win_k, win_v, tables, size), = cache.decode_view()["win_stacks"]
    for step in range(6):
        x = rng.standard_normal((3, 1, tcfg.d_model)).astype(np.float32)
        jy, (jk, jv) = JL.attn_decode(jp, jcfg, jnp.asarray(x), jk, jv,
                                      jnp.asarray(pos), WINDOW)
        h = TL.rms_norm(torch.from_numpy(x), tp["ln"], tcfg.norm_eps)
        ty = TL.attn_decode(tp, tcfg, h, win_k[0], win_v[0], tables,
                            torch.from_numpy(pos + 1), size)
        np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
        for slot in range(3):
            k_ring, v_ring = _ring_rows(cache, 0, slot)
            np.testing.assert_allclose(_np(k_ring), _np(jk[slot]), **TOL)
            np.testing.assert_allclose(_np(v_ring), _np(jv[slot]), **TOL)
        pos = pos + 1


def test_chunked_prefill_then_ring_matches_ring_convert_cache():
    """Reduced gemma3-27b: a 37-token prompt in chunks of 8 (the last of
    5), logits chunk by chunk against JAX's ``prefill_chunk`` (padded), then
    the staged rows of every window layer written into its ring against
    ``ring_convert_cache`` and the full layer's rows against the staged
    buffer itself."""
    jcfg, tcfg, params, model = _bridged("gemma3-27b")
    prompt = np.random.default_rng(3).integers(0, tcfg.vocab_size, 37)
    C, max_len = 8, 64
    jcache = JM.init_cache(jcfg, 1, max_len, dtype=jnp.float32, ring=False)
    tcache = TM.init_cache(tcfg, 1, max_len, dtype=torch.float32,
                           device="cpu")
    for s in range(0, 37, C):
        n = min(C, 37 - s)
        padded = np.zeros((1, C), np.int32)
        padded[0, :n] = prompt[s:s + n]
        jl, jcache = JM.prefill_chunk(params, jcfg, jcache,
                                      jnp.asarray(padded),
                                      n_valid=jnp.asarray([n], jnp.int32))
        tl, tcache = TM.prefill_chunk(
            model, tcache, torch.from_numpy(prompt[s:s + n])[None])
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    ring = JM.ring_convert_cache(jcfg, jcache, max_len, 37)
    win = WindowCache(tcfg, 2, max_len, 4, dtype=torch.float32, device="cpu")
    kinds = TM.layer_caches(tcfg)
    win.write(1, [(tcache["k"][i, 0, :37], tcache["v"][i, 0, :37])
                  for i, (kind, _) in enumerate(kinds) if kind == "win"])
    for i, ((kind, rank), (si, pi, r)) in enumerate(zip(kinds,
                                                        _jax_layers(jcfg))):
        want = ring["stages"][si][f"blk{pi}"]
        if kind == "win":
            got = _ring_rows(win, rank, 1)
            assert want["k"].shape[2] == WINDOW
        else:
            got = (tcache["k"][i, 0], tcache["v"][i, 0])
            assert want["k"].shape[2] == max_len
        for a, key in zip(got, ("k", "v")):
            np.testing.assert_allclose(
                _np(a)[:37], np.asarray(want[key][r, 0])[:37], **TOL)


@pytest.mark.parametrize("L", [13, 20])
def test_decode_step_matches_jax_across_the_wrap(L):
    """Reduced gemma3-27b, two rows of L tokens, six decode steps: at L=13
    the window layers' rings wrap at step 3, at L=20 they have wrapped.
    The full layer reads the paged cache, the window layers their
    rings."""
    jcfg, tcfg, params, model = _bridged("gemma3-27b")
    toks = np.random.default_rng(L).integers(0, tcfg.vocab_size, (2, L))
    max_len = 48
    jl, jcache = JM.prefill(params, jcfg, jnp.asarray(toks, jnp.int32),
                            max_len=max_len)
    tl, states = TM.prefill(model, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    pages = PagedKVCache(tcfg, num_pages=24, page_size=4, slots=2,
                         max_len=max_len, dtype=torch.float32, device="cpu")
    win = WindowCache(tcfg, 2, max_len, 4, dtype=torch.float32, device="cpu")
    kinds = [k for k, _ in TM.layer_caches(tcfg)]
    assert pages.n_attn_layers == 1 and win.stacks[0].k.shape[0] == 7
    for b in range(2):
        pages.allocate(b, L)
        idx = pages.token_index(b, 0, L)
        full = [st for kind, st in zip(kinds, states) if kind == "kv"]
        for layer, (k, v) in enumerate(full):
            pages.write(layer, idx, k[b], v[b])
        win.write(b, [(k[b], v[b]) for kind, (k, v) in zip(kinds, states)
                      if kind == "win"])
    nxt = np.asarray(jnp.argmax(jl, axis=-1))
    for _ in range(6):
        jl, jcache = JM.decode_step(params, jcfg, jcache,
                                    jnp.asarray(nxt[:, None], jnp.int32))
        for b in range(2):
            pages.extend(b, 1)
        view = {**pages.decode_view(), **win.decode_view()}
        tl = TM.decode_step(model, torch.tensor(nxt, dtype=torch.long), view)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        nxt = np.asarray(jnp.argmax(jl, axis=-1))
    assert list(_np(view["context_lens"])) == [L + 6, L + 6]


def _serve(eng, req_cls, prompts, max_new=8):
    for rid, p in enumerate(prompts):
        eng.submit(req_cls(rid=rid, tokens=list(p), prompt_len=len(p),
                           max_new_tokens=max_new))
    return {r.rid: r.generated for r in eng.run_until_drained()}


def _prompts(vocab):
    """Five prompts, four longer than the window of 16."""
    rng = np.random.default_rng(21)
    return [[int(t) for t in rng.integers(1, vocab, n)]
            for n in (21, 9, 37, 17, 30)]


@pytest.fixture(scope="module")
def jax_tokens():
    """The JAX engine's greedy tokens per (arch, chunk), run once each."""
    @functools.lru_cache(maxsize=None)
    def run(arch, chunk):
        jcfg, _, params, _ = _bridged(arch)
        return _serve(JEngine(jcfg, params, max_batch=3, max_len=64,
                              prefill_chunk=chunk), JReq,
                      _prompts(jcfg.vocab_size))
    return run


@pytest.mark.parametrize("chunk", [None, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_match_jax_engine(arch, chunk, jax_tokens):
    """Five requests over three slots, prompts past the window, one-shot
    and in chunks of 8.  mixtral chunks its prefill with a MoE FFN: the
    JAX engine pads the last chunk with token 0 and routes the padding
    too, the port routes real tokens only (ROADMAP C).  At the reduced
    size ``moe_capacity`` gives C = T * K (capacity factor = 4 experts),
    so nothing drops and the padding cannot change a real token's output:
    the tokens must be equal."""
    _, tcfg, _, model = _bridged(arch)
    eng = InferenceEngine(tcfg, model, max_batch=3, max_len=64,
                          prefill_chunk=chunk, page_size=4, device="cpu")
    assert eng.prefill_chunk == chunk
    got = _serve(eng, EngineRequest, _prompts(tcfg.vocab_size))
    assert got == jax_tokens(arch, chunk)
    assert all(len(g) == 8 for g in got.values()) and len(got) == 5
    (ring,) = eng.window.stacks
    assert ring.size == WINDOW
    assert tuple(ring.k.shape[:2]) == (
        sum(b.mixer == "window" for b in tcfg.layer_list()), 3 * 4)
    if arch == "mixtral-8x22b":
        assert eng.cache is None            # every layer is a window layer
        assert tcfg.moe.capacity_factor == tcfg.moe.num_experts
    else:
        assert eng.cache.n_attn_layers == 1
        assert eng.cache.utilization() == 0.0


@pytest.mark.parametrize("arch", ["gemma3-27b", "mixtral-8x22b"])
def test_slot_reused_after_a_longer_request(arch):
    """One slot: a 40-token request, then a 6-token one.  The second must
    get the tokens it gets alone: the first request's ring rows stay in
    the slot but lie past the second's context, and the JAX engine agrees."""
    jcfg, tcfg, params, model = _bridged(arch)
    rng = np.random.default_rng(5)
    long, short = ([int(t) for t in rng.integers(1, tcfg.vocab_size, n)]
                   for n in (40, 6))

    def port():
        return InferenceEngine(tcfg, model, max_batch=1, max_len=64,
                               page_size=4, device="cpu")
    eng = port()
    first = _serve(eng, EngineRequest, [long])
    (ring,) = eng.window.stacks
    stale = ring.k.clone()
    assert stale[:, 3].any()                 # rows 12..15 of the ring
    eng.completed.clear()
    eng.submit(EngineRequest(rid=1, tokens=list(short), prompt_len=6,
                             max_new_tokens=8))
    reused = {r.rid: r.generated for r in eng.run_until_drained()}[1]
    alone = _serve(port(), EngineRequest, [short])[0]
    assert reused == alone
    jeng = JEngine(jcfg, params, max_batch=1, max_len=64)
    assert _serve(jeng, JReq, [long]) == first
    jeng.completed.clear()
    jeng.submit(JReq(rid=1, tokens=list(short), prompt_len=6,
                     max_new_tokens=8))
    assert {r.rid: r.generated for r in jeng.run_until_drained()}[1] == alone
    # rows 14 and 15 (page 3) were not rewritten: still the first's
    assert torch.equal(ring.k[:, 3, 2:], stale[:, 3, 2:])


@pytest.mark.parametrize("ctx", [0, 1])
def test_free_row_writes_only_its_own_ring(ctx):
    """A free row (length 0 without a paged cache, 1 with one) writes row 0
    of its own ring and nothing else: the other slots' rings, NaN, stay
    NaN bit for bit, and its output is finite (zeros at length 0)."""
    tcfg = reduce_config(get_config("gemma3-27b"))
    cache = WindowCache(_one_window_layer(tcfg), 3, 64, 4,
                        dtype=torch.float32, device="cpu")
    g = torch.Generator().manual_seed(0)
    (ring,) = cache.stacks
    ring.k.normal_(generator=g)
    ring.v.normal_(generator=g)
    n = ring.pages_per_slot
    for t in (ring.k, ring.v):
        t[0, :n] = float("nan")
        t[0, 2 * n:] = float("nan")
    before = (ring.k.clone(), ring.v.clone())
    tp = TL.init_attention(tcfg, g, torch.float32)
    x = torch.randn((1, 1, tcfg.d_model), generator=g)
    y = TL.attn_decode(tp, tcfg, TL.rms_norm(x, tp["ln"], tcfg.norm_eps),
                       ring.k[0], ring.v[0], ring.tables[1:2],
                       torch.tensor([ctx], dtype=torch.int32), ring.size)
    assert bool(torch.isfinite(y).all())
    if ctx == 0:
        assert not y.any()
    for t, t0 in zip((ring.k, ring.v), before):
        assert t[0, :n].isnan().all() and t[0, 2 * n:].isnan().all()
        rows = t[0, n:2 * n].reshape(n * 4, -1)
        rows0 = t0[0, n:2 * n].reshape(n * 4, -1)
        changed = (rows != rows0).any(dim=-1)
        assert changed.tolist() == [True] + [False] * (n * 4 - 1)


def test_engine_free_rows_write_only_row_zero():
    """mixtral's engine has no paged cache: the step's context lengths are
    each request's tokens, 0 in a free row, whose ring gets row 0 only."""
    _, tcfg, _, model = _bridged("mixtral-8x22b")
    eng = InferenceEngine(tcfg, model, max_batch=3, max_len=32, page_size=4,
                          device="cpu")
    assert eng._dev.numel() == 2 * 3 and eng.cache is None
    eng.submit(EngineRequest(rid=0, tokens=list(range(1, 21)), prompt_len=20,
                             max_new_tokens=6))
    eng.step()
    eng.step()
    assert eng._view["context_lens"].tolist() == [22, 0, 0]
    (ring,) = eng.window.stacks
    assert eng._view["win_stacks"][0][0] is ring.k
    n = ring.pages_per_slot
    free = ring.k[:, n:].reshape(2, 2, n * 4, -1)   # slots 1 and 2
    assert free[:, :, 0].any() and not free[:, :, 1:].any()


# -- window layers of two sizes ----------------------------------------------

MIXED = (WINDOW, 8)          # the window layers of each pattern take turns


@functools.lru_cache(maxsize=None)
def _bridged_mixed():
    """Reduced gemma3-27b (5 window + 1 full, then 2 window layers) with
    its window layers at 16, 8, 16, 8, 16 and 16, 8, bridged."""
    jcfg = alternate_windows(jax_reduce(jax_get_config("gemma3-27b")), MIXED)
    tcfg = alternate_windows(reduce_config(get_config("gemma3-27b")), MIXED)
    params = JM.init_params(jcfg, jax.random.PRNGKey(6), dtype=jnp.float32)
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                            device="cpu")
    return jcfg, tcfg, params, model


def _windows(cfg):
    return [b.window for b in cfg.layer_list() if b.mixer == "window"]


@pytest.mark.parametrize("max_len,page", [(64, 4), (64, 5), (12, 4),
                                          (8, 16)])
def test_mixed_windows_keep_one_stack_per_ring_size(max_len, page):
    """One stack per S = min(window, max_len), in the order the sizes come,
    each layer at its rank in its stack; the rings' bytes are the sum over
    layers of slots * ceil(S / page) * page * KV * hd * 2 * itemsize.  At
    max_len 8 both windows give rings of 8: one stack."""
    _, tcfg, _, _ = _bridged_mixed()
    assert _windows(tcfg) == [16, 8, 16, 8, 16, 16, 8]
    cache = WindowCache(tcfg, 3, max_len, page, dtype=torch.float32,
                        device="cpu")
    sizes = [min(w, max_len) for w in _windows(tcfg)]
    order = list(dict.fromkeys(sizes))
    assert [st.size for st in cache.stacks] == order
    for i, (j, rank) in enumerate(cache.where):
        assert order[j] == sizes[i]
        assert rank == sizes[:i].count(sizes[i])
    for st in cache.stacks:
        assert st.k.shape[0] == sizes.count(st.size)
        assert torch.equal(st.tables, torch.arange(
            3 * st.pages_per_slot, dtype=torch.int32).view(3, -1))
    per_row = tcfg.num_kv_heads * tcfg.head_dim * 2 * 4
    assert cache.nbytes == sum(3 * -(-S // page) * page * per_row
                               for S in sizes)
    assert len(order) == (1 if max_len == 8 else 2)


@pytest.mark.parametrize("L", [5, 12, 37])
def test_mixed_window_prefill_into_rings_matches_to_ring(L):
    """``WindowCache.write`` puts each layer's last min(L, S) rows at t % S
    of its own ring, S = 16 or 8, as ``_to_ring`` does."""
    _, tcfg, _, _ = _bridged_mixed()
    cache = WindowCache(tcfg, 2, 64, 4, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(L)
    n = len(cache.where)
    kv = rng.standard_normal((n, 2, L, 1, tcfg.head_dim)).astype(np.float32)
    cache.write(1, [(torch.from_numpy(k), torch.from_numpy(v))
                    for k, v in kv])
    for i, ((j, rank), w) in enumerate(zip(cache.where, _windows(tcfg))):
        st = cache.stacks[j]
        npg = st.pages_per_slot
        for t, a in zip((st.k, st.v), kv[i]):
            got = t[rank, npg:2 * npg].reshape(npg * 4, -1)[:w]
            want = np.asarray(JM._to_ring(jnp.asarray(a[None]), w))[0]
            np.testing.assert_array_equal(_np(got), want.reshape(w, -1))
            assert not t[rank, :npg].any()           # slot 0 untouched


@pytest.mark.parametrize("L", [7, 13])
def test_mixed_window_decode_step_matches_jax_across_the_wrap(L):
    """Two rows of L tokens, ten decode steps: the rings of 8 wrap first
    (at L=13 they have wrapped already), the rings of 16 within the
    steps; every step's logits within 1e-4 of the JAX ring decode."""
    jcfg, tcfg, params, model = _bridged_mixed()
    toks = np.random.default_rng(L).integers(0, tcfg.vocab_size, (2, L))
    max_len = 48
    jl, jcache = JM.prefill(params, jcfg, jnp.asarray(toks, jnp.int32),
                            max_len=max_len)
    tl, states = TM.prefill(model, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    pages = PagedKVCache(tcfg, num_pages=24, page_size=4, slots=2,
                         max_len=max_len, dtype=torch.float32, device="cpu")
    win = WindowCache(tcfg, 2, max_len, 4, dtype=torch.float32, device="cpu")
    assert [st.size for st in win.stacks] == [16, 8]
    kinds = [k for k, _ in TM.layer_caches(tcfg)]
    for b in range(2):
        pages.allocate(b, L)
        idx = pages.token_index(b, 0, L)
        full = [st for kind, st in zip(kinds, states) if kind == "kv"]
        for layer, (k, v) in enumerate(full):
            pages.write(layer, idx, k[b], v[b])
        win.write(b, [(k[b], v[b]) for kind, (k, v) in zip(kinds, states)
                      if kind == "win"])
    nxt = np.asarray(jnp.argmax(jl, axis=-1))
    for _ in range(10):
        jl, jcache = JM.decode_step(params, jcfg, jcache,
                                    jnp.asarray(nxt[:, None], jnp.int32))
        for b in range(2):
            pages.extend(b, 1)
        view = {**pages.decode_view(), **win.decode_view()}
        tl = TM.decode_step(model, torch.tensor(nxt, dtype=torch.long), view)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        nxt = np.asarray(jnp.argmax(jl, axis=-1))


@pytest.mark.parametrize("chunk", [None, 8])
def test_mixed_window_engine_tokens_match_jax_engine(chunk):
    """Five requests over three slots, prompts past both windows, one-shot
    and in chunks of 8: the greedy tokens equal the JAX engine's."""
    jcfg, tcfg, params, model = _bridged_mixed()
    prompts = _prompts(tcfg.vocab_size)
    eng = InferenceEngine(tcfg, model, max_batch=3, max_len=64,
                          prefill_chunk=chunk, page_size=4, device="cpu")
    got = _serve(eng, EngineRequest, prompts)
    want = _serve(JEngine(jcfg, params, max_batch=3, max_len=64,
                          prefill_chunk=chunk), JReq, prompts)
    assert got == want and len(got) == 5
    assert [st.size for st in eng.window.stacks] == [16, 8]
    assert [tuple(st.k.shape[:2]) for st in eng.window.stacks] == [
        (4, 3 * 4), (3, 3 * 2)]


def test_full_width_ring_bytes():
    """gemma3-27b: 52 window layers x 1024 rows x 16 KV heads x 128 x 2
    (K, V) x 2 bytes per slot; 10 full layers hold pages."""
    cfg = get_config("gemma3-27b")
    kinds = [k for k, _ in TM.layer_caches(cfg)]
    assert kinds.count("win") == 52 and kinds.count("kv") == 10
    assert 52 * 1024 * cfg.num_kv_heads * cfg.head_dim * 2 * 2 == 436_207_616
    assert get_config("gemma3-12b").head_dim == 256
    from repro_torch.launch.serve import cut_periods
    mix = cut_periods(get_config("mixtral-8x22b"), 8)
    assert mix.num_layers == 8 and mix.param_count() == MIXTRAL_8_LAYERS
    assert get_config("mixtral-8x22b").param_count() == 140_630_065_152


# -- the plain kernels at gemma3-12b's head dim 256 ---------------------------

DTYPES = {"float32": (torch.float32, jnp.float32, 2e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def _pair(a, name):
    tdt, jdt, _ = DTYPES[name]
    t = torch.from_numpy(a).to(tdt)
    return t, jnp.asarray(t.float().numpy()).astype(jdt)


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("B,H,KV,ctx", [(3, 16, 8, [0, 40, 129]),
                                        (2, 8, 1, [64, 7])])
def test_plain_paged_at_head_dim_256_matches_jax_oracle(B, H, KV, ctx, name):
    rng = np.random.default_rng(len(ctx) + H)
    page, npg, P, hd = 16, 9, 32, 256
    q, jq = _pair(rng.standard_normal((B, H, hd)).astype(np.float32), name)
    kp, jkp = _pair(rng.standard_normal((P, page, KV, hd)).astype(np.float32),
                    name)
    vp, jvp = _pair(rng.standard_normal((P, page, KV, hd)).astype(np.float32),
                    name)
    bt = rng.integers(0, P, (B, npg)).astype(np.int32)
    lens = np.asarray(ctx, np.int32)
    out = paged_attention(q, kp, vp, torch.from_numpy(bt),
                          torch.from_numpy(lens))
    ref = jax_paged(jq, jkp, jvp, jnp.asarray(bt), jnp.asarray(lens))
    tol = DTYPES[name][2]
    keep = lens > 0              # the JAX oracle averages V at ctx = 0
    np.testing.assert_allclose(_f32(out)[keep], _f32(ref)[keep], rtol=tol,
                               atol=tol)
    assert not _f32(out)[~keep].any()


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("Lq,Lk,window", [(40, 40, None), (24, 70, 16),
                                          (70, 70, 1024)])
def test_plain_flash_at_head_dim_256_matches_jax_oracle(Lq, Lk, window, name):
    rng = np.random.default_rng(Lq + Lk)
    q, jq = _pair(rng.standard_normal((1, Lq, 16, 256)).astype(np.float32),
                  name)
    k, jk = _pair(rng.standard_normal((1, Lk, 8, 256)).astype(np.float32),
                  name)
    v, jv = _pair(rng.standard_normal((1, Lk, 8, 256)).astype(np.float32),
                  name)
    out = flash_attention(q, k, v, window=window)
    ref = jax_attn(jq, jk, jv, window=window)
    tol = DTYPES[name][2]
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("hd", [24, 144, 512])
def test_wrappers_take_head_dim_256_and_no_other_above_128(hd):
    q = torch.zeros(1, 4, 2, 256)
    flash_attention(q, q.clone(), q.clone())
    paged_attention(torch.zeros(1, 2, 256), torch.zeros(2, 4, 1, 256),
                    torch.zeros(2, 4, 1, 256),
                    torch.zeros(1, 1, dtype=torch.int32),
                    torch.ones(1, dtype=torch.int32))
    bad = torch.zeros(1, 4, 2, hd)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(bad, bad.clone(), bad.clone())
    with pytest.raises(ValueError, match="head dim"):
        paged_attention(torch.zeros(1, 2, hd), torch.zeros(2, 4, 1, hd),
                        torch.zeros(2, 4, 1, hd),
                        torch.zeros(1, 1, dtype=torch.int32),
                        torch.ones(1, dtype=torch.int32))
