"""Attention softcap in the port against the JAX package, on the CPU in
fp32, on inputs made with numpy from a seed: the paged kernel's plain
version with a cap against the JAX model's ``_sdpa`` with the same cap on
the gathered K/V (1e-5; a row at ctx 0 gets zeros, as the kernels give
it, where the JAX oracle averages V), over pages and over a ring that has
wrapped; reduced llama3.1-8b and gemma3-27b with ``logit_softcap`` set,
their prefill and decode-step logits within 1e-4 and their engines'
greedy tokens equal to the JAX engine's, one-shot and chunked; and an
fp32 train step (loss, metrics, updated weights and AdamW moments within
the train tests' 1e-4 relative).  c = 50.0 is Gemma 2's
``attn_logit_softcapping`` (hf:google/gemma-2-9b); at the reduced widths
the scores are O(1), where it barely bites, so c = 1.0 runs too."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_train_step as P  # noqa: E402
from test_torch_train_step import B, METRICS, OPT, S, one_thread  # noqa: E402,F401
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduce_config as jax_reduce  # noqa: E402
from repro.engine.engine import EngineRequest as JReq  # noqa: E402
from repro.engine.engine import InferenceEngine as JEngine  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.engine.engine import EngineRequest, InferenceEngine  # noqa: E402
from repro_torch.engine.kv_cache import PagedKVCache  # noqa: E402
from repro_torch.engine.window_cache import WindowCache  # noqa: E402
from repro_torch.kernels.paged_attention.ops import paged_attention  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.training import train_step as TTS  # noqa: E402

KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
CAPS = (50.0, 1.0)
# reduced configs: llama3.1-8b at two layers, gemma3-27b at one repeat of
# each stage (5 window layers of 16 and a full one, then 2 window layers)
LAYERS_PER_STAGE = {"llama3.1-8b": 2, "gemma3-27b": 1}


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


# -- the paged kernel's plain version ------------------------------------------

def _kernel_inputs(rng, G, hd, case):
    """(q [B, H, hd], k/v pages [P, page, KV, hd], block tables, context
    lengths, JAX's dense K/V [B, S, KV, hd] and mask [B, S]).  "empty":
    rows at ctx 0 and 5; "short": ctx 5 and 19 over shuffled pages;
    "wrapped": a ring of 24 rows (3 pages of 8, the identity table), one
    row past the wrap at position 40 and one before it at 10, masked as
    the JAX ring decode masks (``slot <= pos | pos >= S``)."""
    KV, page, n_pages = 2, 8, 3
    H = G * KV
    P = 2 * n_pages + 1
    q = rng.standard_normal((2, H, hd)).astype(np.float32)
    kp = rng.standard_normal((P, page, KV, hd)).astype(np.float32)
    vp = rng.standard_normal((P, page, KV, hd)).astype(np.float32)
    if case == "wrapped":
        bt = np.arange(2 * n_pages, dtype=np.int32).reshape(2, n_pages)
        pos = np.array([40, 10])
        ctx = np.minimum(pos + 1, n_pages * page).astype(np.int32)
        slots = np.arange(n_pages * page)[None]
        mask = (slots <= pos[:, None]) | (pos[:, None] >= n_pages * page)
    else:
        bt = rng.permutation(P)[:2 * n_pages].astype(np.int32).reshape(
            2, n_pages)
        ctx = np.array([0, 5] if case == "empty" else [5, 19], np.int32)
        mask = np.arange(n_pages * page)[None] < ctx[:, None]
    k = kp[bt].reshape(2, n_pages * page, KV, hd)
    v = vp[bt].reshape(2, n_pages * page, KV, hd)
    return q, kp, vp, bt, ctx, k, v, mask


@pytest.mark.parametrize("case", ["empty", "short", "wrapped"])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 4, 8])
def test_plain_paged_softcap_matches_jax_sdpa(G, hd, case):
    rng = np.random.default_rng(G * 1000 + hd + len(case))
    q, kp, vp, bt, ctx, k, v, mask = _kernel_inputs(rng, G, hd, case)
    args = [torch.from_numpy(a) for a in (q, kp, vp, bt, ctx)]
    plain = _np(paged_attention(*args))
    for cap in CAPS:
        got = _np(paged_attention(*args, softcap=cap))
        want = _np(JL._sdpa(jnp.asarray(q[:, None]), jnp.asarray(k),
                            jnp.asarray(v), jnp.asarray(mask[:, None]),
                            cap)).reshape(got.shape)
        live = ctx > 0
        np.testing.assert_allclose(got[live], want[live], **KERNEL_TOL)
        assert not got[~live].any()
        if cap == 1.0:                     # the cap bites at O(1) scores
            assert np.abs(got[live] - plain[live]).max() > 1e-2
    with pytest.raises(ValueError, match="softcap"):
        paged_attention(*args, softcap=0.0)


# -- reduced models ----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _bridged(arch: str, cap):
    lps = LAYERS_PER_STAGE[arch]
    jcfg = dataclasses.replace(
        jax_reduce(jax_get_config(arch), layers_per_stage=lps),
        logit_softcap=cap)
    tcfg = dataclasses.replace(
        reduce_config(get_config(arch), layers_per_stage=lps),
        logit_softcap=cap)
    params = JM.init_params(jcfg, jax.random.PRNGKey(8), dtype=jnp.float32)
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                            device="cpu")
    return jcfg, tcfg, params, model


def _port_caches(tcfg, states, L, max_len):
    """The engine's caches holding ``prefill``'s states of two rows of L
    tokens: pages for the full layers, rings for the window layers."""
    kinds = [k for k, _ in TM.layer_caches(tcfg)]
    view = {}
    pages = PagedKVCache(tcfg, num_pages=2 * max_len // 4, page_size=4,
                         slots=2, max_len=max_len, dtype=torch.float32,
                         device="cpu")
    win = (WindowCache(tcfg, 2, max_len, 4, dtype=torch.float32,
                       device="cpu") if "win" in kinds else None)
    for b in range(2):
        pages.allocate(b, L)
        idx = pages.token_index(b, 0, L)
        full = [st for kind, st in zip(kinds, states) if kind == "kv"]
        for layer, (k, v) in enumerate(full):
            pages.write(layer, idx, k[b], v[b])
        if win is not None:
            win.write(b, [(k[b], v[b]) for kind, (k, v) in zip(kinds, states)
                          if kind == "win"])
    if win is not None:
        view.update(win.decode_view())
    return pages, view


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("arch", ["llama3.1-8b", "gemma3-27b"])
def test_prefill_and_decode_logits_match_jax(arch, cap):
    """Two rows of 13 tokens, then six decode steps (gemma3-27b's rings of
    16 wrap at the fourth): prefill and every step's logits within 1e-4 of
    the JAX package's; at c = 1.0 the cap moves the prefill logits."""
    jcfg, tcfg, params, model = _bridged(arch, cap)
    L, max_len = 13, 48
    toks = np.random.default_rng(len(arch)).integers(0, tcfg.vocab_size,
                                                     (2, L))
    jl, jcache = JM.prefill(params, jcfg, jnp.asarray(toks, jnp.int32),
                            max_len=max_len)
    tl, states = TM.prefill(model, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    if cap == 1.0:
        uncapped, _ = TM.prefill(_bridged(arch, None)[3],
                                 torch.from_numpy(toks))
        assert np.abs(_np(uncapped) - _np(tl)).max() > 100 * TOL["atol"]
    pages, view = _port_caches(tcfg, states, L, max_len)
    nxt = np.asarray(jnp.argmax(jl, axis=-1))
    for _ in range(6):
        jl, jcache = JM.decode_step(params, jcfg, jcache,
                                    jnp.asarray(nxt[:, None], jnp.int32))
        for b in range(2):
            pages.extend(b, 1)
        tl = TM.decode_step(model, torch.tensor(nxt, dtype=torch.long),
                            {**pages.decode_view(), **view})
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        nxt = np.asarray(jnp.argmax(jl, axis=-1))


def _serve(eng, req_cls, prompts, max_new=8):
    for rid, p in enumerate(prompts):
        eng.submit(req_cls(rid=rid, tokens=list(p), prompt_len=len(p),
                           max_new_tokens=max_new))
    return {r.rid: r.generated for r in eng.run_until_drained()}


@pytest.mark.parametrize("chunk", [None, 8])
@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("arch", ["llama3.1-8b", "gemma3-27b"])
def test_engine_tokens_match_jax_engine(arch, cap, chunk):
    """Four requests over three slots, prompts past gemma3-27b's window of
    16, one-shot and in chunks of 8: the greedy tokens equal the JAX
    engine's."""
    jcfg, tcfg, params, model = _bridged(arch, cap)
    rng = np.random.default_rng(31)
    prompts = [[int(t) for t in rng.integers(1, tcfg.vocab_size, n)]
               for n in (21, 9, 30, 17)]
    got = _serve(InferenceEngine(tcfg, model, max_batch=3, max_len=64,
                                 prefill_chunk=chunk, page_size=4,
                                 device="cpu"), EngineRequest, prompts)
    want = _serve(JEngine(jcfg, params, max_batch=3, max_len=64,
                          prefill_chunk=chunk), JReq, prompts)
    assert got == want and len(got) == 4


# -- training ------------------------------------------------------------------

@pytest.mark.parametrize("arch,lps,cap", [("llama3.1-8b", 2, 50.0),
                                          ("llama3.1-8b", 2, 1.0),
                                          ("gemma3-27b", 1, 1.0)])
def test_train_step_matches_jax_fp32(monkeypatch, arch, lps, cap):
    """One fp32 train step (both packages' ``cast_half`` the identity) of a
    capped model through the plain, differentiable attention: loss,
    metrics, every updated weight and both AdamW moments (the first is
    the gradient scaled) within 1e-4 relative of the JAX step's."""
    P.identity_cast(monkeypatch)
    jcfg, tcfg, params, model = P.bridged(arch, lps)
    jcfg = dataclasses.replace(jcfg, logit_softcap=cap)
    tcfg = dataclasses.replace(tcfg, logit_softcap=cap)
    model.cfg = tcfg
    jopt_cfg, topt_cfg = P.opt_configs(**OPT)
    toks, labels, mask = P.batch(tcfg.vocab_size, (B, S), seed=4,
                                 partial_mask=True)
    jp, jo, jm = P.jax_step(("softcap", arch, lps, cap), jcfg, jopt_cfg)(
        params, P.jax_opt(params), jnp.asarray(toks), jnp.asarray(labels),
        jnp.asarray(mask))
    topt = P.port_opt(model)
    _, _, tm = TTS.make_train_step(tcfg, topt_cfg, ce_chunk=P.CE_CHUNK)(
        model, topt, *map(torch.from_numpy, (toks, labels, mask)))
    P.assert_step_matches(model, topt, tm, jp, jo, jm, METRICS)
