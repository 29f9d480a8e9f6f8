"""granite-4.0-h-small on the port: NoPE attention and the muP scalars
(``ModelConfig.position_embedding``, ``embedding_multiplier``,
``residual_multiplier``, ``attention_multiplier``, ``logits_scaling``)
held to the benchmark's float32 reference of the Mamba-2 / MoE hybrid
(``portbench/reference/granite_hybrid.py``) on seeded weights at the
reference's CPU cut (one period of ten layers at small widths, 8 experts
top-2 beside the shared one): prefill logits and the engine's decode
logits through the paged cache and ``SSMStateCache``; one case per field
in which that field alone leaves its default, each showing that a port
ignoring the field would fail; the kernels' plain versions with the new
arguments; the two benchmarked configurations, whose defaults keep every
bit; the registry.

Tolerances: port and reference both compute in float32 here, in other
orders of summation (the port's chunked scan and attention against the
reference's own), so their logits agree to about 1e-6 of the largest
logit; 1e-4 of it leaves room for that, and each field moves the logits
by more than a tenth of it."""
import copy
import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT / "portbench")):
    if p not in sys.path:
        sys.path.insert(0, p)

from pb import program, spec, weights as wts  # noqa: E402
from reference import common as C  # noqa: E402
from repro_torch.configs import ALL_ARCHS, PORT_ONLY_ARCHS, get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig, reduce_config  # noqa: E402
from repro_torch.engine.engine import EngineRequest, InferenceEngine  # noqa: E402
from repro_torch.kernels.decode_fused.ops import add_rms_norm, rope_kv_write  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.paged_attention.ref import paged_attention_ref  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

TOL = 1e-4       # of the largest logit: float32 both sides (module docstring)
MOVED = 0.1      # of the largest logit: what a field moves them by, at least
SEED = 2 ** 31 + 33
CONF = json.loads((ROOT / "portbench" / "configs"
                   / "granite-4.0-h-small.json").read_text())
REF = spec.reference(CONF)

# field of the port section -> (its default there, the reference's key and
# its value at that default)
DEFAULTS = {
    "position_embedding": ("rope", "position_embedding_type", "rope"),
    "embedding_multiplier": (1.0, "embedding_multiplier", 1.0),
    "residual_multiplier": (1.0, "residual_multiplier", 1.0),
    "attention_multiplier": (None, "attention_multiplier", None),
    "logits_scaling": (1.0, "logits_scaling", 1.0),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _with(conf, **fields):
    """The reduced config with every new field at its default but those
    given, which keep their published values."""
    c = copy.deepcopy(conf)
    hd = c["port"]["head_dim"]
    for field, (default, key, ref_default) in DEFAULTS.items():
        if field in fields:
            continue
        if default is None:
            c["port"].pop(field, None)
            c[key] = hd ** -0.5
        else:
            c["port"][field] = default
            c[key] = ref_default
    return c


def _build(conf, dtype=torch.float32, seed=SEED):
    cfg = program.model_config(conf)
    lay = program.layout(cfg, dtype)
    leaves = spec.reference(conf).leaves(conf, lay["top.embed"][0][0])
    W = wts.draw(leaves, seed, lay, "cpu")
    wts.zero_padding(W, leaves, conf["vocab_size"])
    return cfg, W, program.build_model(cfg, W, dtype)


def _prompts(n, lens, seed=1):
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(0, 256, (lens[i],), generator=g).tolist()
            for i in range(n)]


def _serve(cfg, model, prompts, new=6, max_batch=4):
    """Serve ``prompts`` through the engine; returns the requests and each
    decode row's logits as {(rid, position): logits [V]}."""
    eng = InferenceEngine(cfg, model, max_batch=max_batch, max_len=128,
                          device="cpu")
    seen, real = {}, eng._step_logits

    def logits():
        lg = real()
        for i, r in enumerate(eng.slots):
            if r is not None:
                seen[(r.rid, len(r.tokens) - 1)] = lg[i].clone()
        return lg
    eng._step_logits = logits
    reqs = [EngineRequest(rid=i, tokens=list(p), prompt_len=len(p),
                          max_new_tokens=new) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return eng, reqs, seen


def _close(got, want):
    torch.testing.assert_close(got, want, rtol=TOL,
                               atol=TOL * float(want.abs().max()))


def _check_against_reference(conf):
    """Prefill and decode logits of the port within TOL of the reference;
    returns the reference's logits of the first prompt's tokens."""
    cfg, W, model = _build(conf)
    prompts = _prompts(3, [23, 9, 40])
    lg, _ = TM.prefill(model, torch.tensor(prompts[0])[None])
    want = REF.logits(conf, W, [(prompts[0], len(prompts[0]) - 1)],
                      C.Arith("fp32"))[0][0]
    _close(lg[0], want)
    _, reqs, seen = _serve(cfg, model, prompts)
    ref = REF.logits(conf, W, [(r.tokens[:-1], r.prompt_len - 1)
                               for r in reqs], C.Arith("fp32"))
    n = 0
    for r, rows in zip(reqs, ref):
        for pos in range(r.prompt_len, len(r.tokens) - 1):
            _close(seen[(r.rid, pos)], rows[pos - r.prompt_len + 1])
            n += 1
    assert n >= 3 * 4               # every decode step of every request
    return want


def test_the_cut_keeps_one_period_of_the_published_pattern():
    conf = REF.reduced(CONF)
    cfg = program.model_config(conf)
    assert [b.mixer for b in cfg.layer_list()] == \
        ["mamba"] * 5 + ["full"] + ["mamba"] * 4
    assert all(b.ffn == "moe" for b in cfg.layer_list())
    assert (cfg.position_embedding, cfg.embedding_multiplier,
            cfg.residual_multiplier, cfg.attention_multiplier,
            cfg.logits_scaling) == ("nope", 12.0, 0.22, 0.0078125, 16.0)
    assert cfg.moe.num_shared == 1 and cfg.moe.num_experts == 8


def test_prefill_and_engine_decode_match_the_reference():
    _check_against_reference(REF.reduced(CONF))


@pytest.mark.parametrize("field", sorted(DEFAULTS))
def test_each_new_field_alone_matches_the_reference(field):
    """Only ``field`` leaves its default: the port matches the reference,
    and the reference with the field at its default reads other logits,
    so a port that ignored the field would fail the first check."""
    conf = REF.reduced(CONF)
    got = _check_against_reference(_with(conf, **{field: True}))
    _, W, _ = _build(_with(conf, **{field: True}))
    plain = _with(conf)
    toks = _prompts(1, [23])[0]
    ignored = REF.logits(plain, W, [(toks, len(toks) - 1)],
                         C.Arith("fp32"))[0][0]
    assert (got - ignored).abs().max() > MOVED * got.abs().max()


def test_the_configuration_registers_apart_from_the_jax_mirror():
    cfg = get_config("granite-4.0-h-small")
    assert "granite-4.0-h-small" in PORT_ONLY_ARCHS
    assert "granite-4.0-h-small" not in ALL_ARCHS
    assert cfg == program.model_config(CONF)
    assert abs(cfg.param_count() - 32.2e9) < 0.01e9
    with pytest.raises(KeyError):
        get_config("granite-4.0-h-nano")


@pytest.mark.parametrize("kw", [dict(position_embedding="alibi"),
                                dict(embedding_multiplier=0.0),
                                dict(residual_multiplier=-1.0),
                                dict(attention_multiplier=float("inf")),
                                dict(logits_scaling=float("nan"))])
def test_bad_values_of_the_new_fields_raise(kw):
    import dataclasses
    with pytest.raises(ValueError, match=next(iter(kw))):
        dataclasses.replace(get_config("minicpm-2b"), **kw)


@pytest.mark.parametrize("field", ["position_embedding",
                                   "attention_multiplier"])
def test_an_mla_layer_refuses_the_fields_it_cannot_take(field):
    import dataclasses
    cfg = reduce_config(get_config("deepseek-v2-lite-16b"))
    value = "nope" if field == "position_embedding" else 0.1
    with pytest.raises(NotImplementedError, match=field):
        TM.init_params(dataclasses.replace(cfg, **{field: value}),
                       dtype=torch.float32, device="cpu")


def test_training_refuses_logits_scaling():
    from repro_torch.training.train_step import make_loss_fn
    with pytest.raises(NotImplementedError, match="logits_scaling"):
        make_loss_fn(program.model_config(REF.reduced(CONF)))


# -- the kernels' plain versions with the new arguments ----------------------

def _dense_attention(q, k, v, scale, mask):
    """softmax(q k^T * scale) v, GQA by repeating K/V heads: q [B, Lq, H,
    hd], k/v [B, Lk, KV, hd], mask [Lq, Lk] or [B, Lk]."""
    H, KV = q.shape[2], k.shape[2]
    k, v = (t.repeat_interleave(H // KV, dim=2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * scale
    s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v.double())


@pytest.mark.parametrize("scale", [None, 1 / 128, 0.3])
def test_flash_ref_takes_a_scale(scale):
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, n, h, 16, generator=g)
               for n, h in ((9, 4), (13, 2), (13, 2)))
    got = attention_ref(q, k, v, causal=True, scale=scale)
    mask = torch.arange(13)[None, :] <= torch.arange(9)[:, None] + 4
    want = _dense_attention(q, k, v, 16 ** -0.5 if scale is None else scale,
                            mask)
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-6)
    if scale is None:       # the default is the old expression, bit for bit
        assert torch.equal(got, attention_ref(q, k, v, scale=16 ** -0.5))


@pytest.mark.parametrize("scale", [None, 1 / 128, 0.3])
def test_paged_ref_takes_a_scale(scale):
    g = torch.Generator().manual_seed(4)
    B, H, KV, hd, page, n = 3, 8, 2, 16, 4, 5
    q = torch.randn(B, H, hd, generator=g)
    kp, vp = (torch.randn(B * n, page, KV, hd, generator=g) for _ in "kv")
    tables = torch.arange(B * n, dtype=torch.int32).view(B, n)
    lens = torch.tensor([1, 7, 20], dtype=torch.int32)
    got = paged_attention_ref(q, kp, vp, tables, lens, None, scale)
    k = kp[tables.long()].reshape(B, n * page, KV, hd)
    v = vp[tables.long()].reshape(B, n * page, KV, hd)
    mask = (torch.arange(n * page)[None] < lens[:, None].long())[:, None,
                                                                None]
    want = _dense_attention(q[:, None], k, v,
                            hd ** -0.5 if scale is None else scale, mask)
    torch.testing.assert_close(got.double(), want[:, 0], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_add_rms_norm_takes_a_residual_multiplier(dtype):
    g = torch.Generator().manual_seed(5)
    x, y = (torch.randn(4, 1, 64, generator=g).to(dtype) for _ in "xy")
    w = (torch.randn(64, generator=g) * 0.1).to(dtype)
    s, out = add_rms_norm(x, y, w, 1e-5, 0.22)
    want = (x.float() + y.float() * 0.22).to(dtype)       # one rounding
    assert torch.equal(s, want)
    assert torch.equal(out, L.rms_norm(want, w, 1e-5))
    s1, out1 = add_rms_norm(x, y, w, 1e-5)                # the default
    assert torch.equal(s1, x + y) and torch.equal(out1,
                                                  L.rms_norm(x + y, w, 1e-5))
    assert not torch.equal(s, s1)


@pytest.mark.parametrize("ring", [None, 8])
def test_rope_kv_write_without_theta_rotates_nothing(ring):
    g = torch.Generator().manual_seed(6)
    B, H, KV, hd, page = 3, 4, 2, 16, 4
    q, k, v = (torch.randn(B, n, hd, generator=g) for n in (H, KV, KV))
    tables = torch.arange(B * 4, dtype=torch.int32).view(B, 4)
    lens = torch.tensor([1, 6, 11], dtype=torch.int32)
    pools = [torch.zeros(B * 4, page, KV, hd) for _ in range(4)]
    q0 = rope_kv_write(q, k, v, lens, tables, pools[0], pools[1], None,
                       ring=ring)
    assert torch.equal(q0, q)
    # the rows written are k and v as given, where RoPE rotates k
    q1 = rope_kv_write(q, k, v, lens, tables, pools[2], pools[3], 1e4,
                       ring=ring)
    pos = (lens.long() - 1).clamp_min(0)
    row = pos if ring is None else pos % ring
    idx = tables.long().gather(1, (row // page)[:, None])[:, 0] * page \
        + row % page
    assert torch.equal(pools[0].view(-1, KV, hd)[idx], k)
    assert torch.equal(pools[1].view(-1, KV, hd)[idx], v)
    assert torch.equal(pools[1], pools[3])
    assert not torch.equal(pools[0], pools[2])
    assert not torch.equal(q1, q)


# -- the benchmarked configurations keep every bit with the defaults ----------

def _decode_step_before(model, tokens, cache):
    """``models.model.decode_step`` as it was before the muP scalars: the
    plain residual adds and norms, no embedding or logit scale."""
    cfg = model.cfg
    eps = cfg.norm_eps
    x = model.top["embed"][tokens][:, None]
    y = None
    for blk, (kind, i) in zip(model.layers, TM.layer_caches(cfg)):
        if kind == "kv":
            x, h = add_rms_norm(x, y, blk.attn["ln"], eps)
            y = L.attn_decode(blk.attn, cfg, h, cache["k_pages"][i],
                              cache["v_pages"][i], cache["block_tables"],
                              cache["context_lens"])
        else:
            x = x if y is None else x + y
            y = L.mla_decode(blk.attn, cfg, x, cache["ckv"][i],
                             cache["kr"][i], cache["context_lens"])
        if blk.spec.ffn == "dense":
            x, h = add_rms_norm(x, y, blk.ffn["ln"], eps)
            y = L.ffn_decode(blk.ffn, cfg, h)
        else:
            x = x + y
            y, _ = L.moe_forward(blk.ffn, cfg, x)
    _, h = add_rms_norm(x, y, model.top["final_norm"], eps)
    return h[:, 0] @ TM.lm_head_weight(model)


def _prefill_before(model, tokens):
    """``models.model.prefill`` (one-shot, no mesh) as it was before the
    muP scalars."""
    cfg = model.cfg
    x = model.top["embed"][tokens]
    pos = torch.arange(x.shape[1])[None]
    for blk in model.layers:
        if blk.spec.mixer == "full":
            y, _ = L.attn_forward(blk.attn, cfg, x, pos, None)
        else:
            y, _ = L.mla_forward(blk.attn, cfg, x, pos)
        x = x + y
        y = (L.moe_forward(blk.ffn, cfg, x)[0] if blk.spec.ffn == "moe"
             else L.ffn_forward(blk.ffn, cfg, x))
        x = x + y
    x = L.rms_norm(x, model.top["final_norm"], cfg.norm_eps)
    return x[:, -1] @ TM.lm_head_weight(model)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cell", ["minicpm-2b.agentic",
                                  "deepseek-v2-lite-16b.agentic_saturated"])
def test_benchmarked_configs_keep_every_bit(cell, dtype, monkeypatch):
    import repro_torch.engine.engine as E
    conf = spec.load_cell(ROOT, cell).config
    conf = spec.reference(conf).reduced(conf)
    cfg, _, model = _build(conf, dtype)
    prompts = _prompts(3, [17, 5, 30], seed=9)
    toks = torch.tensor(prompts[2])[None]
    assert torch.equal(TM.prefill(model, toks)[0],
                       _prefill_before(model, toks))
    _, reqs, now = _serve(cfg, model, prompts)
    monkeypatch.setattr(E, "decode_step", _decode_step_before)
    _, reqs_b, before = _serve(cfg, model, prompts)
    assert [r.tokens for r in reqs] == [r.tokens for r in reqs_b]
    assert now.keys() == before.keys() and len(now) >= 12
    for key in now:
        assert torch.equal(now[key], before[key]), key
