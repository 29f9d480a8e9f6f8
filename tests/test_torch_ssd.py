"""The port's Mamba-2 path against the JAX package on the CPU: the plain
SSD scan against ``ssd_chunked`` and the Pallas kernel (interpret mode), one
bridged mamba layer, reduced mamba2-1.3b prefill and decode logits, the
engine's greedy tokens, and a hybrid model whose decode indexes pages by
attention layer.  Tolerance fp32 1e-4, as ``tests/test_kernels.py`` holds
the SSD kernel to its oracle."""
import dataclasses

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
from repro.kernels.ssd.ssd import ssd_pallas  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssd as JS  # noqa: E402
from repro_torch.configs import base as port_base  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.engine.engine import EngineRequest, InferenceEngine  # noqa: E402
from repro_torch.engine.kv_cache import PagedKVCache  # noqa: E402
from repro_torch.engine.state_cache import SSMStateCache  # noqa: E402
from repro_torch.kernels.ssd.ops import ssd  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import ssd as TS  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
SHAPES = [(2, 128, 4, 32, 1, 16, 32),       # tests/test_kernels.py:102-106
          (1, 256, 8, 64, 2, 32, 64),
          (2, 64, 2, 16, 1, 128, 16)]


def _np(t):
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _ssd_inputs(B, L, H, P, G, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    B_ = (rng.standard_normal((B, L, G, N)) * 0.3).astype(np.float32)
    C = (rng.standard_normal((B, L, G, N)) * 0.3).astype(np.float32)
    return x, dt, A, B_, C


def _check_against_jax(args, Q, oracle):
    y, st = ssd(*map(torch.from_numpy, args), chunk=Q)
    jargs = map(jnp.asarray, args)
    if oracle == "ssd_chunked":
        yr, str_ = JS.ssd_chunked(*jargs, chunk=Q)
    else:
        yr, str_ = ssd_pallas(*jargs, chunk=Q, interpret=True)
    assert y.dtype == st.dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(yr), **TOL)
    np.testing.assert_allclose(_np(st), _np(str_), **TOL)
    return y


@pytest.mark.parametrize("oracle", ["ssd_chunked", "ssd_pallas"])
@pytest.mark.parametrize("B,L,H,P,G,N,Q", SHAPES)
def test_plain_ssd_matches_jax(B, L, H, P, G, N, Q, oracle):
    _check_against_jax(_ssd_inputs(B, L, H, P, G, N), Q, oracle)


@pytest.mark.parametrize("oracle", ["ssd_chunked", "ssd_pallas"])
@pytest.mark.parametrize("B,L,H,P,G,N,Q", SHAPES)
def test_plain_ssd_matches_jax_with_slow_decay(B, L, H, P, G, N, Q, oracle):
    """dt and A as ``init_mamba`` draws them (dt near 1e-3..0.1, A = -1..-H):
    the slow heads carry O(1) weight across chunks, which the inputs above
    decay to nothing within a chunk."""
    x, _, _, B_, C = _ssd_inputs(B, L, H, P, G, N, seed=7)
    rng = np.random.default_rng(8)
    dt0 = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), H))
    dt_bias = dt0 + np.log(-np.expm1(-dt0))
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)) + dt_bias)
                  ).astype(np.float32)
    A = -np.arange(1, H + 1, dtype=np.float32)
    args = (x, dt, A, B_, C)
    y = _check_against_jax(args, Q, oracle)
    # the carried state matters: chunks run alone give another answer
    alone = torch.cat([ssd(*(torch.from_numpy(np.ascontiguousarray(
        a[:, i:i + Q])) if a.ndim > 1 else torch.from_numpy(a)
        for a in args), chunk=Q)[0] for i in range(0, L, Q)], dim=1)
    assert (y - alone).abs().max() > 1e-2 * y.abs().max()


def test_plain_ssd_follows_the_pallas_kernel_in_bf16():
    """bf16 x/B/C: the port, like the Pallas kernel, computes the scan in
    f32 after widening; ``ssd_chunked`` rounds the intra-chunk weights to
    bf16 first (ROADMAP queue C)."""
    x, dt, A, B_, C = _ssd_inputs(2, 128, 4, 32, 1, 16, seed=1)
    tb = [torch.from_numpy(a).bfloat16() for a in (x, B_, C)]
    jb = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in tb]
    y, st = ssd(tb[0], torch.from_numpy(dt), torch.from_numpy(A), tb[1],
                tb[2], chunk=32)
    yr, str_ = ssd_pallas(jb[0], jnp.asarray(dt), jnp.asarray(A), jb[1],
                          jb[2], chunk=32, interpret=True)
    np.testing.assert_allclose(_np(y), _np(yr), **TOL)
    np.testing.assert_allclose(_np(st), _np(str_), **TOL)


def test_ssd_rejects_what_the_kernel_does_not_take():
    x, dt, A, B_, C = map(torch.from_numpy, _ssd_inputs(1, 48, 4, 16, 2, 16))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd(x, dt, A, B_, C, chunk=32)
    with pytest.raises(ValueError, match="group"):
        ssd(x[:, :, :3].contiguous(), dt[:, :, :3].contiguous(), A[:3], B_,
            C, chunk=16)
    with pytest.raises(TypeError, match="float32"):
        ssd(x, dt.double(), A, B_, C, chunk=16)
    wide = torch.zeros(1, 48, 1, 72)
    with pytest.raises(ValueError, match="head dim"):
        ssd(wide, dt[:, :, :1].contiguous(), A[:1], B_[:, :, :1].contiguous(),
            C[:, :, :1].contiguous(), chunk=16)


@pytest.fixture(scope="module")
def bridged():
    jcfg = jax_reduce(jax_get_config("mamba2-1.3b"), layers_per_stage=2)
    tcfg = reduce_config(get_config("mamba2-1.3b"), layers_per_stage=2)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                            device="cpu")
    return jcfg, tcfg, params, model


def test_mamba_layer_forward_and_decode_match_jax(bridged):
    jcfg, tcfg, params, model = bridged
    jp = jax.tree.map(lambda a: a[0], params["stages"][0]["blk0"]["mixer"])
    p = model.layers[0].mixer
    x = np.random.default_rng(2).standard_normal(
        (2, 37, tcfg.d_model)).astype(np.float32)   # 37: three chunks, ragged
    jy, (jconv, jst) = JS.mamba_forward(jp, jcfg, jnp.asarray(x),
                                        return_state=True)
    ty, (tconv, tst) = TS.mamba_forward(p, tcfg, torch.from_numpy(x),
                                        return_state=True)
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    np.testing.assert_allclose(_np(tst), _np(jst), **TOL)
    for k in ("x", "B", "C"):
        assert tconv[k].shape == (2, 3, jconv[k].shape[-1])
        np.testing.assert_allclose(_np(tconv[k]), _np(jconv[k]), **TOL)
    for t in range(3):
        step = np.random.default_rng(3 + t).standard_normal(
            (2, 1, tcfg.d_model)).astype(np.float32)
        jy, (jconv, jst) = JS.mamba_decode(jp, jcfg, jnp.asarray(step),
                                           jconv, jst)
        ty, (tconv, tst) = TS.mamba_decode(p, tcfg, torch.from_numpy(step),
                                           tconv, tst)
        np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
        np.testing.assert_allclose(_np(tst), _np(jst), **TOL)


def test_short_prompt_conv_tail_is_front_padded(bridged):
    _, tcfg, _, model = bridged
    x = torch.randn(1, 2, tcfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    _, (conv, _) = TS.mamba_forward(model.layers[0].mixer, tcfg, x,
                                    return_state=True)
    assert conv["x"].shape[1] == 3 and not conv["x"][:, 0].any()


def _prefill_into(states: SSMStateCache, slot_states, slots):
    for b, slot in enumerate(slots):
        states.write(slot, [({k: v[b] for k, v in conv.items()}, st[b])
                            for conv, st in slot_states])


def test_reduced_prefill_and_decode_logits_match_jax(bridged):
    jcfg, tcfg, params, model = bridged
    toks = np.random.default_rng(4).integers(0, tcfg.vocab_size, (2, 21))
    jl, jcache = JM.prefill(params, jcfg, jnp.asarray(toks, jnp.int32),
                            max_len=32)
    tl, layer_states = TM.prefill(model, torch.from_numpy(toks))
    assert len(layer_states) == tcfg.num_layers == 2
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    states = SSMStateCache(tcfg, 4, dtype=torch.float32, device="cpu")
    slots = [3, 1]                     # rows land in arbitrary slots
    _prefill_into(states, layer_states, slots)
    nxt = np.asarray(jnp.argmax(jl, axis=-1))
    for _ in range(3):
        jl, jcache = JM.decode_step(params, jcfg, jcache,
                                    jnp.asarray(nxt[:, None], jnp.int32))
        # the step runs over every slot, row b being slot b; free rows
        # decode token 0
        toks = torch.zeros(4, dtype=torch.long)
        toks[slots] = torch.from_numpy(nxt).long()
        tl = TM.decode_step(model, toks, states.decode_view())
        np.testing.assert_allclose(_np(tl[slots]), _np(jl), **TOL)
        nxt = np.asarray(jnp.argmax(jl, axis=-1))
    # the decode updated each row's state in its own slot
    jst = jcache["stages"][0]["blk0"]["ssm"]            # [layers, B, ...]
    np.testing.assert_allclose(_np(states.ssm[:, slots]), _np(jst), **TOL)
    # the free slots evolved alike from zero on token 0
    assert torch.equal(states.ssm[:, 0], states.ssm[:, 2])
    assert all(torch.equal(c[:, 0], c[:, 2]) for c in states.conv.values())


def _serve(eng, req_cls, prompts, max_new=6):
    for rid, p in enumerate(prompts):
        eng.submit(req_cls(rid=rid, tokens=list(p), prompt_len=len(p),
                           max_new_tokens=max_new))
    return {r.rid: r.generated for r in eng.run_until_drained()}


def test_engine_matches_jax_engine_with_chunking_gated_off(bridged):
    jcfg, tcfg, params, model = bridged
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(0, 256, n)]
               for n in (9, 17, 33, 5)]
    port = InferenceEngine(tcfg, model, max_batch=3, max_len=64,
                           prefill_chunk=8, device="cpu")
    assert port.prefill_chunk is None          # mamba is not chunk-resumable
    jeng = JEngine(jcfg, params, max_batch=3, max_len=64, prefill_chunk=8)
    assert jeng.prefill_chunk is None
    got = _serve(port, EngineRequest, prompts)
    want = _serve(jeng, JReq, prompts)
    assert got == want and len(got) == 4
    assert port.cache is None                  # no attention layer: no pages
    assert port.slots == [None] * 3             # every slot released


def test_checkpoint_request_frees_the_state_slot(bridged):
    """The freed slot takes the next request, whose prefill overwrites the
    checkpointed request's state: both decode as if alone."""
    _, tcfg, _, model = bridged
    eng = InferenceEngine(tcfg, model, max_batch=2, max_len=48, device="cpu")
    for rid in range(2):
        eng.submit(EngineRequest(rid=rid, tokens=list(range(1, 12)),
                                 prompt_len=11, max_new_tokens=8))
    eng.step()
    assert [r.rid for r in eng.slots] == [0, 1]
    snap = eng.checkpoint_request(1)
    assert snap.rid == 1 and len(snap.generated) == 2
    assert eng.slots[1] is None
    other = list(range(20, 29))
    eng.submit(EngineRequest(rid=2, tokens=list(other), prompt_len=9,
                             max_new_tokens=8))
    eng.step()
    assert eng.slots[1].rid == 2
    reused = {r.rid: r.generated for r in eng.run_until_drained()}[2]
    dst = InferenceEngine(tcfg, model, max_batch=2, max_len=48, device="cpu")
    dst.submit(snap)
    resumed = dst.run_until_drained()[0].generated
    ref = InferenceEngine(tcfg, model, max_batch=2, max_len=48, device="cpu")
    whole = _serve(ref, EngineRequest, [list(range(1, 12))], max_new=8)[0]
    alone = _serve(ref, EngineRequest, [other], max_new=8)[0]
    assert resumed == whole and reused == alone


def _hybrid(cfg, base):
    """Reduced mamba2-1.3b cut to two layers: mamba, then full attention
    with a dense FFN."""
    stage = base.Stage(pattern=(base.BlockSpec("mamba", "none"),
                                base.BlockSpec("full", "dense")), repeat=1)
    return dataclasses.replace(cfg, name="hybrid-reduced", family="hybrid",
                               num_layers=2, stages=(stage,))


def test_hybrid_decode_indexes_pages_by_attention_layer():
    """Pages stack attention layers only: the full layer, second in the
    model, reads page layer 0.  Logits agree with JAX over three steps."""
    jcfg = _hybrid(jax_reduce(jax_get_config("mamba2-1.3b")), jax_base)
    tcfg = _hybrid(reduce_config(get_config("mamba2-1.3b")), port_base)
    params = JM.init_params(jcfg, jax.random.PRNGKey(3), dtype=jnp.float32)
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                            device="cpu")
    toks = np.random.default_rng(6).integers(0, tcfg.vocab_size, (1, 19))
    jl, jcache = JM.prefill(params, jcfg, jnp.asarray(toks, jnp.int32),
                            max_len=32)
    tl, layer_states = TM.prefill(model, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    pages = PagedKVCache(tcfg, num_pages=4, page_size=8, slots=1, max_len=32,
                         dtype=torch.float32, device="cpu")
    assert pages.k_pages.shape[0] == 1
    pages.allocate(0, 19)
    k, v = layer_states[1]
    pages.write(0, pages.token_index(0, 0, 19), k[0], v[0])
    states = SSMStateCache(tcfg, 1, dtype=torch.float32, device="cpu")
    assert states.ssm.shape[0] == 1
    _prefill_into(states, layer_states[:1], [0])
    nxt = np.asarray(jnp.argmax(jl, axis=-1))
    for _ in range(3):
        jl, jcache = JM.decode_step(params, jcfg, jcache,
                                    jnp.asarray(nxt[:, None], jnp.int32))
        pages.extend(0, 1)
        tl = TM.decode_step(model, torch.tensor(nxt),
                            {**pages.decode_view(), **states.decode_view()})
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        nxt = np.asarray(jnp.argmax(jl, axis=-1))


def test_serve_launcher_reduced_mamba_on_cpu(capsys):
    from repro_torch.launch.serve import main
    report = main(["--arch", "mamba2-1.3b", "--device", "cpu", "--size",
                   "reduced", "--n-requests", "4", "--max-new", "3"])
    engines = report["engines"]
    assert sum(len(e.completed) for e in engines) == 4
    assert all(e.prefill_chunk is None for e in engines)   # both one-shot
    assert all(e.cache is None and e.states is not None for e in engines)
    assert "served 4 requests" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# The CUDA kernel's decomposition, emulated in plain torch on the CPU: pass 1
# (seg, each chunk's own state contribution, C Bᵀ once per group), pass 2
# (the recurrence over chunk states), pass 3 (the chunk scan).  With
# ``split``, each fp32 operand that the bf16 route feeds to the tensor cores
# (the weighted x, the starting state, att) is rounded to hi + lo, hi =
# bf16(v), lo = bf16(v - hi), as the kernel rounds it; bf16 products
# accumulate exactly in fp32.
# ---------------------------------------------------------------------------

def _hi(v):
    return v.to(torch.bfloat16).float()


def _hi_lo(v):
    return _hi(v) + _hi(v - _hi(v))


def _passes(x, dt, A, B_, C, chunk, split, rnd=_hi_lo):
    Bsz, L, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    nc, rep = L // chunk, H // G
    rnd = rnd if split else (lambda v: v)
    xc = x.float().reshape(Bsz, nc, chunk, H, P)
    dtc = dt.float().reshape(Bsz, nc, chunk, H)
    Bc = B_.float().reshape(Bsz, nc, chunk, G, N)
    Cc = C.float().reshape(Bsz, nc, chunk, G, N)
    # pass 1: every chunk at once
    seg = torch.cumsum(dtc * A.float(), dim=2)                # [B,nc,Q,H]
    w = torch.exp(seg[:, :, -1:] - seg) * dtc
    wx = rnd(xc * w[..., None])                               # [B,nc,Q,H,P]
    own = torch.einsum("bcjhp,bcjhn->bchpn", wx,
                       Bc.repeat_interleave(rep, dim=3))
    cb = torch.einsum("bcign,bcjgn->bcgij", Cc, Bc)           # once per group
    # pass 2: S_0 = 0, S_c = exp(seg_last) S_{c-1} + s_c
    start = torch.zeros_like(own)
    S = torch.zeros_like(own[:, 0])
    for c in range(nc):
        start[:, c] = S
        S = torch.exp(seg[:, c, -1])[..., None, None] * S + own[:, c]
    # pass 3: the chunk scan
    sh = seg.transpose(2, 3)                                  # [B,nc,H,Q]
    diff = sh[..., :, None] - sh[..., None, :]
    causal = torch.ones(chunk, chunk, dtype=torch.bool).tril()
    att = torch.where(causal, cb.repeat_interleave(rep, dim=2)
                      * torch.exp(diff.masked_fill(~causal, float("-inf")))
                      * dtc.transpose(2, 3)[..., None, :], 0.0)
    y = torch.einsum("bchij,bcjhp->bcihp", rnd(att), xc)
    y = y + torch.exp(seg)[..., None] * torch.einsum(
        "bcihn,bchpn->bcihp", Cc.repeat_interleave(rep, dim=3), rnd(start))
    return y.reshape(Bsz, L, H, P), S


def _slow_decay_inputs(B, L, H, P, G, N):
    """As ``test_plain_ssd_matches_jax_with_slow_decay`` draws them."""
    x, _, _, B_, C = _ssd_inputs(B, L, H, P, G, N, seed=7)
    rng = np.random.default_rng(8)
    dt0 = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), H))
    dt_bias = dt0 + np.log(-np.expm1(-dt0))
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)) + dt_bias)
                  ).astype(np.float32)
    A = -np.arange(1, H + 1, dtype=np.float32)
    return x, dt, A, B_, C


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("oracle", ["ssd_chunked", "ssd_pallas"])
@pytest.mark.parametrize("B,L,H,P,G,N,Q", SHAPES)
def test_kernel_passes_match_jax(B, L, H, P, G, N, Q, oracle, split):
    args = _slow_decay_inputs(B, L, H, P, G, N)
    y, st = _passes(*map(torch.from_numpy, args), chunk=Q, split=split)
    jargs = map(jnp.asarray, args)
    if oracle == "ssd_chunked":
        yr, str_ = JS.ssd_chunked(*jargs, chunk=Q)
    else:
        yr, str_ = ssd_pallas(*jargs, chunk=Q, interpret=True)
    np.testing.assert_allclose(_np(y), _np(yr), **TOL)
    np.testing.assert_allclose(_np(st), _np(str_), **TOL)


def test_kernel_passes_match_plain_in_bf16_at_mamba_head_shape():
    """mamba2-1.3b's head shape (P=64, N=128, chunk 256) over two chunks,
    bf16 x/B/C, every fp32 operand split as the tensor-core route splits
    it: within 1e-4 of the plain version's largest magnitude."""
    args = list(map(torch.from_numpy, _slow_decay_inputs(1, 512, 4, 64, 1,
                                                         128)))
    for i in (0, 3, 4):
        args[i] = args[i].bfloat16()
    y, st = _passes(*args, chunk=256, split=True)
    yr, str_ = ssd(*args, chunk=256)
    assert (y - yr).abs().max() <= 1e-4 * yr.abs().max()
    assert (st - str_).abs().max() <= 1e-4 * str_.abs().max()
    y32, st32 = _passes(*args, chunk=256, split=False)
    assert (y32 - yr).abs().max() <= 1e-4 * yr.abs().max()
    assert (st32 - str_).abs().max() <= 1e-4 * str_.abs().max()
    # the lo part matters: rounding each operand to bf16 once misses
    y1, _ = _passes(*args, chunk=256, split=True, rnd=_hi)
    assert (y1 - yr).abs().max() > 1e-4 * yr.abs().max()


def test_workspace_shapes():
    from repro_torch.kernels.ssd.ops import workspace_shapes
    ws = workspace_shapes(1, 2048, 64, 1, 64, 128, 256)
    assert ws == {"seg": (1, 64, 2048), "states": (1, 8, 64, 64, 128),
                  "start": (1, 8, 64, 64, 128), "cb": (1, 8, 1, 256, 256)}
    assert 4 * np.prod(ws["states"]) == 16_777_216          # 16.8 MB
    assert 4 * np.prod(ws["cb"]) == 2_097_152               # 2.1 MB
    # C Bᵀ rows and columns are whole 64-row tiles
    assert workspace_shapes(3, 192, 8, 2, 16, 16, 16) == {
        "seg": (3, 8, 192), "states": (3, 12, 8, 16, 16),
        "start": (3, 12, 8, 16, 16), "cb": (3, 12, 2, 64, 64)}
    assert workspace_shapes(2, 768, 8, 4, 24, 40, 96)["cb"] == (
        2, 8, 4, 128, 128)
