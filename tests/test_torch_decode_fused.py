"""The fused decode glue's wrappers (``kernels/decode_fused``) on the CPU,
where each takes its plain version: held bit for bit against the decode
step's chains as the model layers write them, in bf16 and fp32.
``add_rms_norm`` against ``x + y`` then ``rms_norm``; ``rope_kv_write``
against qk_norm and ``rope`` of q and k, then the K/V stores at the paged
index (a free row on the scratch page) or the ring index (before and after
the ring wraps, and a row of length 0); ``act_mul`` against silu and
tanh-gelu.  Also: the wrappers launch nothing on the CPU, refuse inputs
that require grad, refuse malformed inputs, and on meta tensors report
their bytes to ``_build.record_cost``.  The kernels themselves run only on
the card (``chip_smoke.py`` phase 2 holds them to the same chains)."""
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_fused import ops  # noqa: E402
from repro_torch.kernels.decode_fused.ops import (act_mul, add_rms_norm,  # noqa: E402
                                                  rope_kv_write)
from repro_torch.models import layers as TL  # noqa: E402

DTYPES = (torch.float32, torch.bfloat16)
EPS = 1e-6
THETA = 10000.0


def _rand(g, *shape, dtype, std=1.0):
    return (torch.randn(shape, generator=g) * std).to(dtype)


def _launches():
    return add_rms_norm.launches, rope_kv_write.launches, act_mul.launches


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("with_y", [True, False])
def test_add_rms_norm_is_the_add_then_rms_norm(dtype, with_y):
    g = torch.Generator().manual_seed(0)
    x = _rand(g, 5, 1, 96, dtype=dtype)
    y = _rand(g, 5, 1, 96, dtype=dtype) if with_y else None
    w = _rand(g, 96, dtype=dtype, std=0.1)
    before = _launches()
    s, h = add_rms_norm(x, y, w, EPS)
    want = x + y if with_y else x
    assert s.dtype == h.dtype == dtype
    assert torch.equal(s, want)
    assert torch.equal(h, TL.rms_norm(want, w, EPS))
    if not with_y:
        assert s is x
    assert _launches() == before


def _chain(q, k, v, lens, tables, k_pages, v_pages, q_norm, k_norm,
           ring):
    """The decode step's chain before the fused kernel: qk_norm and rope
    of ``_qkv``, then the paged index of the paged layer or the ring index
    of the window layer, and two indexed stores."""
    page = k_pages.shape[1]
    pos = lens.long() - 1
    if ring is not None:
        pos = pos.clamp_min(0)
    if q_norm is not None:
        q = TL.rms_norm(q, q_norm, EPS)
        k = TL.rms_norm(k, k_norm, EPS)
    q = TL.rope(q[:, None], pos[:, None], THETA)[:, 0]
    k = TL.rope(k[:, None], pos[:, None], THETA)[:, 0]
    row = pos if ring is None else pos % ring
    idx = tables.long().gather(1, (row // page)[:, None])[:, 0] * page \
        + row % page
    k_pages.view(-1, *k_pages.shape[2:])[idx] = k
    v_pages.view(-1, *v_pages.shape[2:])[idx] = v
    return q


def _rope_inputs(hd, qk_norm, ring, dtype, seed=1, B=4, H=4, KV=2, page=4):
    g = torch.Generator().manual_seed(seed)
    if ring is None:
        n = 5
        # row 0 is free: length 1 on the scratch page 0
        lens = torch.tensor([1, 7, 20, 13][:B], dtype=torch.int32)
        tables = (torch.arange(B * n, dtype=torch.int32) + 1).reshape(B, n)
        tables[0] = 0
        P = B * n + 1
    else:
        n = -(-ring // page)
        # a row of length 0, one before the wrap, one at it, one past it
        lens = torch.tensor([0, ring - 1, ring + 1, 3 * ring + 2][:B],
                            dtype=torch.int32)
        tables = torch.arange(B * n, dtype=torch.int32).reshape(B, n)
        P = B * n
    return dict(
        q=_rand(g, B, H, hd, dtype=dtype), k=_rand(g, B, KV, hd, dtype=dtype),
        v=_rand(g, B, KV, hd, dtype=dtype), lens=lens, tables=tables,
        k_pages=_rand(g, P, page, KV, hd, dtype=dtype),
        v_pages=_rand(g, P, page, KV, hd, dtype=dtype),
        q_norm=_rand(g, hd, dtype=dtype, std=0.1) if qk_norm else None,
        k_norm=_rand(g, hd, dtype=dtype, std=0.1) if qk_norm else None)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("ring", [None, 6, 16], ids=["paged", "ring6",
                                                      "ring16"])
@pytest.mark.parametrize("qk_norm", [False, True], ids=["plain", "qk_norm"])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_rope_kv_write_is_the_rope_and_the_two_stores(hd, qk_norm, ring,
                                                     dtype):
    a = _rope_inputs(hd, qk_norm, ring, dtype)
    mine = (a["k_pages"].clone(), a["v_pages"].clone())
    before = _launches()
    q = rope_kv_write(a["q"], a["k"], a["v"], a["lens"], a["tables"], *mine,
                      THETA, a["q_norm"], a["k_norm"], EPS, ring)
    want = _chain(a["q"], a["k"], a["v"], a["lens"], a["tables"],
                  a["k_pages"], a["v_pages"], a["q_norm"], a["k_norm"], ring)
    assert q.dtype == dtype and q.shape == a["q"].shape
    assert torch.equal(q, want)
    assert torch.equal(mine[0], a["k_pages"])
    assert torch.equal(mine[1], a["v_pages"])
    assert _launches() == before


@pytest.mark.parametrize("ring", [None, 6])
def test_rope_kv_write_touches_one_slot_a_row(ring):
    """Each row writes exactly its slot: the free paged row its scratch
    page's first row, the ring row of length 0 its ring's row 0."""
    a = _rope_inputs(64, False, ring, torch.float32)
    k0 = a["k_pages"].clone()
    rope_kv_write(a["q"], a["k"], a["v"], a["lens"], a["tables"],
                  a["k_pages"], a["v_pages"], THETA, eps=EPS, ring=ring)
    changed = (a["k_pages"] != k0).flatten(2).any(-1)     # [P, page]
    pos = a["lens"].long() - 1
    row = pos if ring is None else pos.clamp_min(0) % ring
    want = torch.zeros_like(changed)
    for b in range(len(row)):
        want[a["tables"][b, row[b] // 4], row[b] % 4] = True
    assert torch.equal(changed, want)
    # row 0 (free: length 1 on the scratch page, or 0 before its ring)
    # writes the first row of page 0
    assert changed[0, 0]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_act_mul_is_the_activation_times_up(act, dtype):
    g = torch.Generator().manual_seed(2)
    gate = _rand(g, 3, 1, 77, dtype=dtype, std=3.0)
    up = _rand(g, 3, 1, 77, dtype=dtype)
    want = (F.gelu(gate, approximate="tanh") if act == "gelu"
            else F.silu(gate)) * up
    before = _launches()
    assert torch.equal(act_mul(gate, up, act), want)
    assert torch.equal(act_mul(gate, up, act), TL._act(act)(gate) * up)
    assert _launches() == before


def test_rope_table_is_ropes_own_and_built_once():
    t = ops.rope_table(THETA, 64, torch.device("cpu"))
    assert torch.equal(t, TL.rope_freqs(64, THETA, torch.device("cpu")))
    assert ops.rope_table(THETA, 64, torch.device("cpu")) is t
    # rope's angles at position p are p * t
    x = torch.zeros(1, 1, 1, 64)
    x[..., :32] = 1.0
    got = TL.rope(x, torch.tensor([[5]]), THETA)[0, 0, 0, :32]
    assert torch.equal(got, torch.cos(5.0 * t))


def _rope_call(a, **kw):
    args = dict(q=a["q"], k=a["k"], v=a["v"], context_lens=a["lens"],
                tables=a["tables"], k_pages=a["k_pages"],
                v_pages=a["v_pages"], theta=THETA, q_norm=a["q_norm"],
                k_norm=a["k_norm"], eps=EPS, ring=None)
    args.update(kw)
    return rope_kv_write(**args)


@pytest.mark.parametrize("bad", ["odd_hd", "hd_past_256", "one_norm",
                                 "int64_lens", "pages_kv", "ring0",
                                 "mixed_dtype"])
def test_rope_kv_write_rejects_bad_input(bad):
    hd = 32
    a = _rope_inputs(hd, True, None, torch.float32)
    kw = {}
    if bad == "odd_hd":
        kw = dict(q=a["q"][..., :31].contiguous(),
                  k=a["k"][..., :31].contiguous(),
                  v=a["v"][..., :31].contiguous(),
                  k_pages=a["k_pages"][..., :31].contiguous(),
                  v_pages=a["v_pages"][..., :31].contiguous(),
                  q_norm=None, k_norm=None)
    elif bad == "hd_past_256":
        b = _rope_inputs(288, False, None, torch.float32)
        kw = {k: b[k] for k in ("q", "k", "v", "k_pages", "v_pages")}
        kw.update(q_norm=None, k_norm=None)
    elif bad == "one_norm":
        kw = dict(k_norm=None)
    elif bad == "int64_lens":
        kw = dict(context_lens=a["lens"].long())
    elif bad == "pages_kv":
        kw = dict(k_pages=a["k_pages"][:, :, :1].contiguous(),
                  v_pages=a["v_pages"][:, :, :1].contiguous())
    elif bad == "ring0":
        kw = dict(ring=0)
    else:
        kw = dict(v=a["v"].to(torch.bfloat16))
    with pytest.raises((ValueError, TypeError)):
        _rope_call(a, **kw)


def test_norm_and_act_reject_bad_input():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError):
        add_rms_norm(x, torch.zeros(2, 4), torch.zeros(8), EPS)
    with pytest.raises(ValueError):
        add_rms_norm(x, None, torch.zeros(4), EPS)
    with pytest.raises(TypeError):
        add_rms_norm(x, x.double(), torch.zeros(8), EPS)
    with pytest.raises(TypeError):
        add_rms_norm(x.half(), None, torch.zeros(8).half(), EPS)
    with pytest.raises(ValueError):
        act_mul(x, x, "relu")
    with pytest.raises(ValueError):
        act_mul(x, torch.zeros(2, 4), "silu")


def test_wrappers_refuse_inputs_that_require_grad():
    """Forward only, as the other kernels: with grad mode on an input that
    requires grad raises, on the CPU too; under ``no_grad`` it runs."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 16, generator=g)
    w = torch.zeros(16)
    a = _rope_inputs(32, False, None, torch.float32)
    calls = {
        "add_rms_norm": lambda t: add_rms_norm(t, x, w, EPS),
        "rope_kv_write": lambda t: _rope_call(a, q=t),
        "act_mul": lambda t: act_mul(t, x, "silu"),
    }
    leaves = {"add_rms_norm": x, "rope_kv_write": a["q"], "act_mul": x}
    for name, call in calls.items():
        t = leaves[name].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="forward only"):
            call(t)
        with torch.no_grad():
            call(t)
        call(t.detach())


def test_wrappers_on_meta_report_their_bytes():
    """A dry run's wrappers compute nothing, launch nothing, and report each
    kernel's bytes: every input read once and every output written once."""
    seen = []
    _build.COST_SINKS.append(lambda *r: seen.append(r))
    try:
        meta = dict(device="meta", dtype=torch.bfloat16)
        x = torch.empty(16, 1, 2304, **meta)
        w = torch.empty(2304, **meta)
        before = _launches()
        s, h = add_rms_norm(x, x, w, EPS)
        add_rms_norm(x, None, w, EPS)
        q = torch.empty(16, 36, 64, **meta)
        kv = torch.empty(16, 36, 64, **meta)
        pages = torch.empty(65, 16, 36, 64, **meta)
        lens = torch.empty(16, dtype=torch.int32, device="meta")
        tables = torch.empty(16, 4, dtype=torch.int32, device="meta")
        qo = rope_kv_write(q, kv, kv, lens, tables, pages, pages, THETA)
        gate = torch.empty(16, 1, 5760, **meta)
        z = act_mul(gate, gate, "silu")
        assert _launches() == before
    finally:
        _build.COST_SINKS.pop()
    assert s.shape == h.shape == x.shape and qo.shape == q.shape
    assert z.shape == gate.shape and z.device.type == "meta"
    n, d = 16 * 2304, 2304
    assert [(name, b) for name, _, b in seen] == [
        ("add_rms_norm", 2 * (4 * n + d)), ("add_rms_norm", 2 * (2 * n + d)),
        ("rope_kv_write", 2 * (2 * 16 * 72 * 64 + 2 * 16 * 36 * 64)
         + 4 * (32 + 2 * 16)),
        ("act_mul", 2 * 3 * 16 * 5760)]
    assert all(f > 0 for _, f, _ in seen)
