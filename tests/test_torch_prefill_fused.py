"""The fused prefill (``models/model.py`` ``_fused_layers``) on the CPU,
where each fused wrapper takes its plain chain: held bit for bit to the
plain layers it replaces (``_plain_layers`` with the prompt's or the
chunk's mixer call: each norm, RoPE, K/V store, activation and residual
add on its own) on the last token's logits, every layer's decode state,
every page row the engine writes and every row of the staging cache.  Reduced configurations: a
minicpm-shaped MHA at head dim 64 with silu, GQA with qk_norm (qwen3-32b),
NoPE with the muP scalars (a residual multiplier of 0.22 and an attention
scale), window layers with an attention softcap and tanh-gelu
(gemma3-27b), MoE behind window layers (mixtral-8x22b), MLA with MoE
(deepseek-v2-lite-16b) and the Mamba-2 / NoPE / MoE hybrid
(granite-4.0-h-small), whose MLA, mamba and MoE blocks keep their own
code.  Each prompt runs one-shot and, where the config is chunk-resumable,
in chunks of 8 with a ragged last chunk.  Also: ``rope_kv_prefill``
against qk_norm, ``rope`` and the two stores; spies on the wrappers (a
dense layer calls ``add_rms_norm`` twice, ``rope_kv_prefill`` and
``act_mul`` once; training and a mesh call none); and one dense prefill
layer's aten dispatches (the fused wrappers and ``flash_attention`` one op
each), 102 on the plain layers, held at 30 or fewer; and the dispatches of
``prefill``, ``prefill_chunk``, ``decode_step`` and ``ring_decode_step``
on each configuration, held to those of the six layer loops that the
fused and plain loops replaced.  The kernels
themselves run only on the card (``chip_smoke.py`` phase 2 holds them to
the same chains)."""
import collections
import dataclasses

import pytest

torch = pytest.importorskip("torch")
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.configs.base import uniform_stage  # noqa: E402
from repro_torch.distributed.context import NULL_CTX  # noqa: E402
from repro_torch.engine.engine import EngineRequest, InferenceEngine  # noqa: E402
from repro_torch.kernels.decode_fused import ops  # noqa: E402
from repro_torch.kernels.decode_fused.ops import rope_kv_prefill  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.model import init_cache, init_params  # noqa: E402

DTYPES = (torch.bfloat16, torch.float32)
EPS = 1e-6
THETA = 10000.0
CHUNK = 8
PROMPT = 29                      # chunks of 8, 8, 8 and a ragged 5
MAX_DISPATCHES = 30              # a dense prefill layer; 102 before
NORMS = ("ln", "q_norm", "k_norm", "final_norm")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread per test module: the tier-1 run's workers share the
    host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _minicpm_shaped(**fields):
    """minicpm-2b's layer (MHA, head dim 64, silu, tied) at small width."""
    c = get_config("minicpm-2b")
    return dataclasses.replace(c, num_layers=2, stages=uniform_stage(2),
                               d_model=256, num_heads=4, num_kv_heads=4,
                               head_dim=64, d_ff=512, vocab_size=512,
                               **fields)


def _reduced(arch: str, lps: int = 2, **fields):
    return dataclasses.replace(reduce_config(get_config(arch),
                                             layers_per_stage=lps), **fields)


CONFIGS = {
    "minicpm": lambda: _minicpm_shaped(),
    "gqa_qk_norm": lambda: _reduced("qwen3-32b"),
    "nope_mup": lambda: _minicpm_shaped(
        position_embedding="nope", residual_multiplier=0.22,
        attention_multiplier=1 / 64, embedding_multiplier=12.0,
        logits_scaling=8.0),
    "window_softcap": lambda: _reduced("gemma3-27b", 1, logit_softcap=50.0),
    "moe": lambda: _reduced("mixtral-8x22b"),
    "mla": lambda: _reduced("deepseek-v2-lite-16b"),
    "hybrid": lambda: _reduced("granite-4.0-h-small", 1),
}
CHUNKABLE = ("minicpm", "gqa_qk_norm", "nope_mup", "window_softcap", "moe")


def _model(name: str, dtype):
    """The config's model with its norm weights drawn away from zero, so
    that a norm taken with the wrong weight shows."""
    cfg = CONFIGS[name]()
    model = init_params(cfg, torch.Generator().manual_seed(5), dtype=dtype,
                        device="cpu")
    g = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for pname, p in model.named_parameters():
            if pname.split(".")[-1] in NORMS:
                p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    return cfg, model


def _tokens(cfg, B: int, n: int, seed: int = 7):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (B, n), generator=g)


def _leaves(state):
    """The tensors of one layer's decode state, in a fixed order."""
    if isinstance(state, dict):
        return [t for k in sorted(state) for t in _leaves(state[k])]
    if isinstance(state, (tuple, list)):
        return [t for s in state for t in _leaves(s)]
    return [state]


def _plain_prefill(model, tokens):
    """``prefill`` through the plain layers: (logits, states)."""
    x = TM.embed_tokens(model, tokens)
    h, states, _ = TM._plain_layers(model, x, TM._positions(x.shape[1],
                                                            x.device), True)
    return TM.logits_fn(model, h[:, -1]), states


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_one_shot_prefill_is_the_plain_chain(name, dtype):
    cfg, model = _model(name, dtype)
    tokens = _tokens(cfg, 2, PROMPT)
    with torch.no_grad():
        logits, states = TM.prefill(model, tokens)
        want, want_states = _plain_prefill(model, tokens)
        hidden, _ = TM.model_forward(model, tokens)
        x = TM.embed_tokens(model, tokens)
        want_hidden = TM._plain_layers(model, x, TM._positions(PROMPT, "cpu"),
                                       False)[0]
    assert logits.dtype == want.dtype and torch.equal(logits, want)
    assert torch.equal(hidden, want_hidden)
    assert len(states) == len(want_states) == cfg.num_layers
    for got, ref in zip(states, want_states):
        got, ref = _leaves(got), _leaves(ref)
        assert len(got) == len(ref)
        assert all(a.shape == b.shape and torch.equal(a, b)
                   for a, b in zip(got, ref))


@pytest.mark.parametrize("name", ["minicpm", "gqa_qk_norm", "nope_mup",
                                  "window_softcap"])
def test_engine_pages_hold_the_plain_rows(name):
    """A one-shot admission writes, in every full attention layer's pages,
    the rows of the plain chain's K and V."""
    cfg, model = _model(name, torch.bfloat16)
    toks = _tokens(cfg, 1, PROMPT)
    eng = InferenceEngine(cfg, model, max_batch=2, max_len=64, device="cpu")
    with torch.no_grad():
        _, want = _plain_prefill(model, toks)
        eng._prefill_into_slot(1, EngineRequest(
            rid=0, tokens=toks[0].tolist(), prompt_len=PROMPT,
            max_new_tokens=2))
    idx = eng.cache.token_index(1, 0, PROMPT)
    kv = [st for (kind, _), st in zip(TM.layer_caches(cfg), want)
          if kind == "kv"]
    assert kv
    for layer, (k, v) in enumerate(kv):
        for pages, ref in ((eng.cache.k_pages, k), (eng.cache.v_pages, v)):
            rows = pages[layer].view(-1, *pages.shape[3:])[idx]
            assert torch.equal(rows, ref[0])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("name", CHUNKABLE)
def test_chunked_prefill_is_the_plain_chain(name, dtype):
    """Chunks of 8 from position 0, the last one ragged (5 rows at pos0
    24): each chunk's logits and the whole staging cache, every row and
    every layer, after each chunk."""
    cfg, model = _model(name, dtype)
    tokens = _tokens(cfg, 2, PROMPT)
    fused = init_cache(cfg, 2, 40, dtype=dtype, device="cpu")
    plain = init_cache(cfg, 2, 40, dtype=dtype, device="cpu")
    with torch.no_grad():
        for pos0 in range(0, PROMPT, CHUNK):
            chunk = tokens[:, pos0:pos0 + CHUNK]
            logits, _ = TM.prefill_chunk(model, fused, chunk)
            x = TM._scaled_embed(model, chunk)
            mix = TM._chunk_mixer(model, x, plain, pos0, NULL_CTX, False)
            h = TM._plain_layers(model, x, None, False, mix=mix)[0]
            plain["pos"] = pos0 + chunk.shape[1]
            assert torch.equal(logits, TM.logits_fn(model, h[:, -1]))
            assert fused["pos"] == plain["pos"]
            assert torch.equal(fused["k"], plain["k"])
            assert torch.equal(fused["v"], plain["v"])
    assert bool(fused["k"][:, :, PROMPT - 1].abs().sum() > 0)


class _Spies:
    """Calls of the fused wrappers and the flash kernel's wrapper, counted
    where the model and the layers call them."""
    NAMES = ((TM, "add_rms_norm"), (TL, "rope_kv_prefill"),
             (TL, "rope_kv_write"), (TL, "act_mul"),
             (TL, "flash_attention"))

    def __init__(self, monkeypatch):
        self.calls = collections.Counter()
        for mod, name in self.NAMES:
            real = getattr(mod, name)

            def counted(*a, _real=real, _name=name, **kw):
                self.calls[_name] += 1
                return _real(*a, **kw)
            monkeypatch.setattr(mod, name, counted)

    def take(self) -> dict:
        out = {name: self.calls[name] for _, name in self.NAMES}
        self.calls.clear()
        return out


def _wanted(cfg, calls: int) -> dict:
    """The fused wrappers' calls in ``calls`` prefill calls of ``cfg``: an
    ``add_rms_norm`` before each full or window attention layer and dense
    FFN and one at the final norm, a ``rope_kv_prefill`` and a flash call
    per attention layer, an ``act_mul`` per dense FFN."""
    blocks = cfg.layer_list()
    attn = sum(b.mixer in ("full", "window") for b in blocks)
    dense = sum(b.ffn == "dense" for b in blocks)
    return {"add_rms_norm": (attn + dense + 1) * calls,
            "rope_kv_prefill": attn * calls, "rope_kv_write": 0,
            "act_mul": dense * calls, "flash_attention": attn * calls}


@pytest.mark.parametrize("name", ["minicpm", "moe", "mla", "hybrid"])
def test_prefill_calls_each_fused_wrapper_per_layer(name, monkeypatch):
    cfg, model = _model(name, torch.bfloat16)
    spies = _Spies(monkeypatch)
    tokens = _tokens(cfg, 1, PROMPT)
    with torch.no_grad():
        TM.prefill(model, tokens)
        assert spies.take() == _wanted(cfg, 1)
        TM.model_forward(model, tokens)
        assert spies.take() == _wanted(cfg, 1)
        if name in CHUNKABLE:
            cache = init_cache(cfg, 1, 40, device="cpu")
            for pos0 in range(0, PROMPT, CHUNK):
                TM.prefill_chunk(model, cache, tokens[:, pos0:pos0 + CHUNK])
            assert spies.take() == _wanted(cfg, -(-PROMPT // CHUNK))
    if name == "minicpm":     # two dense layers
        assert _wanted(cfg, 1)["add_rms_norm"] == 5


def test_training_forward_calls_no_fused_wrapper(monkeypatch):
    cfg, model = _model("minicpm", torch.float32)
    spies = _Spies(monkeypatch)
    tokens = _tokens(cfg, 2, 16)
    hidden, _ = TM.model_forward(model, tokens, train=True, remat=False)
    assert all(n == 0 for n in spies.take().values())
    with torch.no_grad():
        fused, _ = TM.model_forward(model, tokens)
    # the plain training forward computes what the fused serving one does,
    # in other kernels (plain attention in fp32 scores): close, not equal
    assert torch.allclose(hidden, fused, atol=1e-4)


@pytest.fixture(scope="module")
def mesh_ctx():
    """The port's ctx over a 1 x 1 gloo mesh of this process."""
    import torch.distributed as dist
    from repro_torch.launch import sharded as SH
    started = not dist.is_initialized()
    SH.start_world(device="cpu")
    yield SH.mesh_ctx(1, 1, device="cpu")
    if started:
        dist.destroy_process_group()


@pytest.mark.parametrize("chunk", [None, CHUNK])
def test_mesh_engine_calls_no_fused_wrapper(chunk, mesh_ctx, monkeypatch):
    """Under a mesh the engine's prefill (one-shot and chunked) keeps the
    plain layers, and its ring decode too, and serves the tokens the engine
    with no mesh serves."""
    cfg, model = _model("minicpm", torch.float32)
    spies = _Spies(monkeypatch)
    out = []
    for ctx in (mesh_ctx, None):
        kw = {} if ctx is None else {"ctx": ctx}
        eng = InferenceEngine(cfg, model, max_batch=2, max_len=40,
                              prefill_chunk=chunk, device="cpu", **kw)
        for rid, n in enumerate((19, 11)):
            eng.submit(EngineRequest(rid=rid, tokens=_tokens(cfg, 1, n, rid)
                                     [0].tolist(), prompt_len=n,
                                     max_new_tokens=3))
        out.append({r.rid: r.generated for r in eng.run_until_drained()})
        calls = spies.take()
        if ctx is not None:
            prefills = 2 if chunk is None else 3 + 2
            assert calls == {"add_rms_norm": 0, "rope_kv_prefill": 0,
                             "rope_kv_write": 0, "act_mul": 0,
                             "flash_attention": cfg.num_layers * prefills}
        else:
            assert calls["rope_kv_prefill"] > 0
    assert out[0] == out[1]


class _Count(TorchDispatchMode):
    """aten dispatches, each fused wrapper and ``flash_attention`` counted
    as one op (the ops inside them not at all)."""

    def __init__(self):
        super().__init__()
        self.n, self.inside = 0, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += not self.inside
        return func(*args, **(kwargs or {}))

    def one_op(self, fn):
        def wrapped(*a, **kw):
            self.n += not self.inside
            self.inside += 1
            try:
                return fn(*a, **kw)
            finally:
                self.inside -= 1
        return wrapped


def _dispatches(layers: int, chunk: bool, monkeypatch) -> int:
    """aten dispatches of a one-shot admission (prefill and the page
    writes) or of one chunk call of a minicpm-shaped model of ``layers``
    layers."""
    cfg = dataclasses.replace(_minicpm_shaped(), num_layers=layers,
                              stages=uniform_stage(layers))
    model = init_params(cfg, seed=0, dtype=torch.bfloat16, device="cpu")
    eng = InferenceEngine(cfg, model, max_batch=2, max_len=128, device="cpu",
                          prefill_chunk=64 if chunk else None)
    toks = list(range(1, 101))
    mode = _Count()
    with monkeypatch.context() as m:
        for mod, name in ((TM, "add_rms_norm"), (TL, "rope_kv_prefill"),
                          (TL, "act_mul"), (TL, "flash_attention")):
            m.setattr(mod, name, mode.one_op(getattr(mod, name)))
        with torch.no_grad(), mode:
            if chunk:
                eng._stage_cache["pos"] = 64
                TM.prefill_chunk(model, eng._stage_cache,
                                 torch.tensor([toks[:36]]))
            else:
                eng._prefill_into_slot(0, EngineRequest(
                    rid=0, tokens=toks, prompt_len=100, max_new_tokens=4))
    return mode.n


@pytest.mark.parametrize("chunk", [False, True], ids=["one_shot", "chunk"])
def test_dense_prefill_layer_dispatches_at_most_30(chunk, monkeypatch):
    """One dense layer's dispatches: a model of three layers less one of
    two.  The plain layers dispatched 102 (one-shot, with the page
    writes) and 105 (a chunk)."""
    n = _dispatches(3, chunk, monkeypatch) - _dispatches(2, chunk,
                                                         monkeypatch)
    assert 0 < n <= MAX_DISPATCHES


# aten dispatches of each entry point in bf16 (the fused wrappers, flash and
# paged attention one op each) as the six layer loops that the fused and
# plain loops replaced made them: a prefill of 2 x 29 tokens, a chunk of 2 x
# 8 at position 8, a decode step over an engine's view (2 slots, one busy)
# and a ring decode step of 2 rows
LOOP_DISPATCHES = {
    "minicpm": {"prefill": 44, "chunk": 55, "decode": 71, "ring": 316},
    "gqa_qk_norm": {"prefill": 41, "chunk": 52, "decode": 70, "ring": 351},
    "nope_mup": {"prefill": 46, "chunk": 57, "decode": 73, "ring": 250},
    "window_softcap": {"prefill": 138, "chunk": 185, "decode": 270,
                       "ring": 1384},
    "moe": {"prefill": 195, "chunk": 206, "decode": 208, "ring": 425},
    "mla": {"prefill": 651, "decode": 717, "ring": 735},
    "hybrid": {"prefill": 3977, "decode": 2208, "ring": 2253},
}


def _dropped(cfg) -> int:
    """What a prefill or chunk call no longer dispatches: the aux loss it
    threw away (its zeros and an add per MoE layer) and each MLA layer's
    own positions (an arange and its unsqueeze: the prompt's serve)."""
    blocks = cfg.layer_list()
    return (1 + sum(b.ffn == "moe" for b in blocks)
            + 2 * sum(b.mixer == "mla" for b in blocks))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_entry_points_dispatch_as_the_layer_loops_did(name, monkeypatch):
    """Decode and ring decode dispatch exactly what they did; prefill and
    a chunk that less only what ``_dropped`` counts."""
    cfg, model = _model(name, torch.bfloat16)
    toks = _tokens(cfg, 2, PROMPT)
    eng = InferenceEngine(cfg, model, max_batch=2, max_len=64, device="cpu")
    eng.submit(EngineRequest(rid=0, tokens=toks[0, :11].tolist(),
                             prompt_len=11, max_new_tokens=4))
    with torch.no_grad():
        eng.step()
        _, states = TM.prefill(model, toks)
    ring = TM.to_ring_cache(cfg, states, 40, PROMPT)
    cache = init_cache(cfg, 2, 40, dtype=torch.bfloat16, device="cpu")
    cache["pos"] = CHUNK
    calls = {"prefill": lambda: TM.prefill(model, toks),
             "chunk": lambda: TM.prefill_chunk(model, cache,
                                               toks[:, CHUNK:2 * CHUNK]),
             "decode": lambda: TM.decode_step(model, eng._dev[:2], eng._view),
             "ring": lambda: TM.ring_decode_step(model, toks[:, :1], ring)}
    got = {}
    for entry in LOOP_DISPATCHES[name]:
        mode = _Count()
        with monkeypatch.context() as m:
            for mod, fn in ((TM, "add_rms_norm"), (TL, "rope_kv_prefill"),
                            (TL, "rope_kv_write"), (TL, "act_mul"),
                            (TL, "flash_attention"), (TL, "paged_attention")):
                m.setattr(mod, fn, mode.one_op(getattr(mod, fn)))
            with torch.no_grad(), mode:
                calls[entry]()
        got[entry] = mode.n
    want = dict(LOOP_DISPATCHES[name])
    for entry in ("prefill", "chunk"):
        if entry in want:
            want[entry] -= _dropped(cfg)
    assert got == want


# ---------------------------------------------------------------------------
# rope_kv_prefill, the wrapper
# ---------------------------------------------------------------------------

def _rope_inputs(B, Lr, H, KV, hd, qk_norm, dtype, seed=1):
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=g) * std).to(dtype)
    return dict(q=rnd(B, Lr, H, hd), k=rnd(B, Lr, KV, hd), v=rnd(B, Lr, KV, hd),
                q_norm=rnd(hd, std=0.1) if qk_norm else None,
                k_norm=rnd(hd, std=0.1) if qk_norm else None)


def _chain(a, pos0, theta):
    """``_qkv``'s qk_norm and ``rope`` at positions pos0 onward."""
    q, k = a["q"], a["k"]
    if a["q_norm"] is not None:
        q = TL.rms_norm(q, a["q_norm"], EPS)
        k = TL.rms_norm(k, a["k_norm"], EPS)
    if theta is not None:
        pos = (pos0 + torch.arange(q.shape[1]))[None].expand(q.shape[0], -1)
        q, k = TL.rope(q, pos, theta), TL.rope(k, pos, theta)
    return q, k


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("theta", [THETA, None], ids=["rope", "nope"])
@pytest.mark.parametrize("qk_norm", [False, True], ids=["plain", "qk_norm"])
@pytest.mark.parametrize("hd", [16, 64, 256])
def test_rope_kv_prefill_is_qk_norm_rope_and_the_stores(hd, qk_norm, theta,
                                                        dtype):
    B, Lr, H, KV, S, pos0 = 2, 5, 4, 2, 16, 9
    a = _rope_inputs(B, Lr, H, KV, hd, qk_norm, dtype)
    launches = ops.rope_kv_prefill.launches
    q, k = rope_kv_prefill(a["q"], a["k"], a["v"], 0, theta, a["q_norm"],
                           a["k_norm"], EPS)
    wq, wk = _chain(a, 0, theta)
    assert torch.equal(q, wq) and torch.equal(k, wk)
    # into rows pos0 .. pos0 + 4 of a staging layer [B, S, KV, hd]
    g = torch.Generator().manual_seed(2)
    cache = [torch.randn(B, S, KV, hd, generator=g).to(dtype)
             for _ in range(2)]
    want = [c.clone() for c in cache]
    q, k = rope_kv_prefill(a["q"], a["k"], a["v"], pos0, theta, a["q_norm"],
                           a["k_norm"], EPS, cache[0][:, pos0:pos0 + Lr],
                           cache[1][:, pos0:pos0 + Lr])
    wq, wk = _chain(a, pos0, theta)
    want[0][:, pos0:pos0 + Lr] = wk
    want[1][:, pos0:pos0 + Lr] = a["v"]
    assert torch.equal(q, wq)
    assert torch.equal(cache[0], want[0]) and torch.equal(cache[1], want[1])
    assert k.data_ptr() == cache[0][:, pos0].data_ptr()
    assert ops.rope_kv_prefill.launches == launches   # no kernel on the CPU


@pytest.mark.parametrize("bad", ["odd_hd", "hd_past_256", "one_norm",
                                 "one_out", "out_shape", "out_rows",
                                 "mixed_dtype", "neg_pos0", "q_rows"])
def test_rope_kv_prefill_rejects_bad_input(bad):
    a = _rope_inputs(2, 5, 4, 2, 32, True, torch.float32)
    out = [torch.zeros(2, 5, 2, 32) for _ in range(2)]
    kw = dict(q=a["q"], k=a["k"], v=a["v"], pos0=0, theta=THETA,
              q_norm=a["q_norm"], k_norm=a["k_norm"], eps=EPS,
              k_out=out[0], v_out=out[1])
    if bad == "odd_hd":
        kw.update(q=a["q"][..., :31].contiguous(),
                  k=a["k"][..., :31].contiguous(),
                  v=a["v"][..., :31].contiguous(), q_norm=None, k_norm=None,
                  k_out=None, v_out=None)
    elif bad == "hd_past_256":
        b = _rope_inputs(1, 2, 1, 1, 288, False, torch.float32)
        kw.update(q=b["q"], k=b["k"], v=b["v"], q_norm=None, k_norm=None,
                  k_out=None, v_out=None)
    elif bad == "one_norm":
        kw.update(k_norm=None)
    elif bad == "one_out":
        kw.update(v_out=None)
    elif bad == "out_shape":
        kw.update(k_out=out[0][:, :4], v_out=out[1][:, :4])
    elif bad == "out_rows":        # rows of the staging cache, transposed
        kw.update(k_out=torch.zeros(2, 2, 5, 32).transpose(1, 2),
                  v_out=torch.zeros(2, 2, 5, 32).transpose(1, 2))
    elif bad == "mixed_dtype":
        kw.update(v=a["v"].to(torch.bfloat16))
    elif bad == "neg_pos0":
        kw.update(pos0=-1)
    else:
        kw.update(q=a["q"][:, :4].contiguous())
    with pytest.raises((ValueError, TypeError)):
        rope_kv_prefill(**kw)


def test_rope_kv_prefill_refuses_inputs_that_require_grad():
    a = _rope_inputs(1, 3, 2, 2, 16, False, torch.float32)
    q = a["q"].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward only"):
        rope_kv_prefill(q, a["k"], a["v"], 0, THETA)
    with torch.no_grad():
        rope_kv_prefill(q, a["k"], a["v"], 0, THETA)
