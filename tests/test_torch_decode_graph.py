"""The engine's fixed-shape decode step on the CPU: every slot decodes at
one shape (tokens [max_batch], block tables [max_batch, ceil(max_len /
page)], context lengths [max_batch]), free rows against the cache's scratch
page, mamba states updated in place.  On the card the same step is replayed
from a CUDA graph; here it runs eagerly, so these tests hold the padding,
the scratch page and the in-place states to the JAX engine's jitted decode
on bridged weights.  Greedy tokens must be identical.  Reduced gemma3-27b
runs with window layers of two sizes (16 and 8), and one step's calls of
the paged kernel, which the card's graph records, are counted."""
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
from repro.models import init_params as jax_init_params  # noqa: E402
from repro_torch.configs import base as port_base  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.engine.engine import EngineRequest, InferenceEngine  # noqa: E402
from repro_torch.engine.kv_cache import PagedKVCache  # noqa: E402
from repro_torch.launch.serve import alternate_windows  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402

MAX_LEN, PAGE = 64, 4


def _hybrid(cfg, base):
    """Reduced mamba2-1.3b cut to two layers: mamba, then full attention
    with a dense FFN (as in ``test_torch_ssd.py``)."""
    stage = base.Stage(pattern=(base.BlockSpec("mamba", "none"),
                                base.BlockSpec("full", "dense")), repeat=1)
    return dataclasses.replace(cfg, name="hybrid-reduced", family="hybrid",
                               num_layers=2, stages=(stage,))


def _bridged(arch: str, seed: int):
    if arch == "hybrid":
        jcfg = _hybrid(jax_reduce(jax_get_config("mamba2-1.3b")), jax_base)
        tcfg = _hybrid(reduce_config(get_config("mamba2-1.3b")), port_base)
    elif arch == "gemma3-27b-mixed":       # window layers of 16 and of 8
        jcfg = alternate_windows(jax_reduce(jax_get_config("gemma3-27b")),
                                 (16, 8))
        tcfg = alternate_windows(reduce_config(get_config("gemma3-27b")),
                                 (16, 8))
    else:
        jcfg, tcfg = jax_reduce(jax_get_config(arch)), \
            reduce_config(get_config(arch))
    params = jax_init_params(jcfg, jax.random.PRNGKey(seed),
                             dtype=jnp.float32)
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                            device="cpu")
    return jcfg, tcfg, params, model


def _schedule(seed: int):
    """(engine step at which it arrives, rid, prompt, max_new_tokens): six
    requests in four waves with staggered lengths, so rows finish at
    different steps and never more than three run at once."""
    rng = np.random.default_rng(seed)
    waves = [0, 0, 2, 5, 5, 9]
    max_new = [3, 7, 2, 6, 4, 5]
    lens = [13, 6, 17, 9, 21, 11]
    return [(w, rid, [int(t) for t in rng.integers(1, 256, n)], m)
            for rid, (w, n, m) in enumerate(zip(waves, lens, max_new))]


def _run(eng, req_cls, schedule):
    last = max(w for w, *_ in schedule)
    for t in range(last + 1):
        for w, rid, prompt, m in schedule:
            if w == t:
                eng.submit(req_cls(rid=rid, tokens=list(prompt),
                                   prompt_len=len(prompt), max_new_tokens=m))
        eng.step()
    eng.run_until_drained()
    return {r.rid: r.generated for r in eng.completed}


# (arch, weight seed, prefill chunk, allocator pages): the pages are fewer
# than the requests need in all, so released pages are handed out again
CASES = {"llama-one-shot": ("llama3.1-8b", 5, None, 18),
         "llama-chunked": ("llama3.1-8b", 5, 8, 18),
         "mamba": ("mamba2-1.3b", 0, None, None),
         "hybrid": ("hybrid", 3, None, 18),
         "gemma3-mixed": ("gemma3-27b-mixed", 2, None, 18),
         "gemma3-mixed-chunked": ("gemma3-27b-mixed", 2, 8, 18)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_padded_step_matches_jax_engine_with_rows_finishing_and_pages_reused(
        case):
    arch, seed, chunk, num_pages = CASES[case]
    jcfg, tcfg, params, model = _bridged(arch, seed)
    schedule = _schedule(11)
    port = InferenceEngine(tcfg, model, max_batch=4, max_len=MAX_LEN,
                           prefill_chunk=chunk, page_size=PAGE,
                           num_pages=num_pages, device="cpu")
    got = _run(port, EngineRequest, schedule)
    want = _run(JEngine(jcfg, params, max_batch=4, max_len=MAX_LEN,
                        prefill_chunk=chunk), JReq, schedule)
    assert got == want and len(got) == len(schedule)
    assert [len(got[rid]) for _, rid, _, _ in schedule] == \
        [m for *_, m in schedule]
    assert port.prefill_chunk == (8 if case.endswith("chunked") else None)
    assert port.slots == [None] * 4 and port.graph_replays == 0
    decodes = [n for kind, n, _ in port.drain_events() if kind == "decode"]
    assert max(decodes) < port.max_batch          # free rows in every step
    if port.cache is not None:
        # each request held ceil((prompt + max_new - 1) / page) pages at its
        # end: more than the allocator has, so pages were reused
        held = sum(-(-(len(p) + m - 1) // PAGE) for _, _, p, m in schedule)
        assert held > num_pages
        assert port.cache.utilization() == 0.0


def _llama_engine(**kw):
    _, tcfg, _, model = _bridged("llama3.1-8b", 5)
    return InferenceEngine(tcfg, model, max_len=MAX_LEN, page_size=PAGE,
                           device="cpu", **kw)


def _new_token_slots(eng):
    """(page, offset) of each active row's newest token."""
    table, lens = eng.cache.table_view()
    out = set()
    for i, r in enumerate(eng.slots):
        if r is not None:
            pos = int(lens[i]) - 1
            out.add((int(table[i, pos // PAGE]), pos % PAGE))
    return out


def test_padded_step_writes_only_scratch_and_new_token_slots():
    eng = _llama_engine(max_batch=4)
    scratch = eng.cache.scratch
    assert tuple(eng._view["block_tables"].shape) == (4, MAX_LEN // PAGE)
    assert tuple(eng._view["context_lens"].shape) == (4,)
    for rid, n in enumerate((7, 10)):
        eng.submit(EngineRequest(rid=rid, tokens=list(range(1, n + 1)),
                                 prompt_len=n, max_new_tokens=8))
    assert not eng.cache.k_pages[:, scratch].any()
    eng.step()                       # two prefills, one step over 4 rows
    assert eng.cache.k_pages[:, scratch, 0].any()   # the free rows wrote
    assert not eng.cache.k_pages[:, scratch, 1:].any()   # slot 0 only
    for _ in range(3):
        k0, v0 = eng.cache.k_pages.clone(), eng.cache.v_pages.clone()
        eng.step()
        allowed = torch.zeros(k0.shape[1:3], dtype=torch.bool)
        allowed[scratch] = True
        new = _new_token_slots(eng)
        assert len(new) == 2
        for page, off in new:
            allowed[page, off] = True
        for before, after in ((k0, eng.cache.k_pages),
                              (v0, eng.cache.v_pages)):
            changed = (before != after).flatten(3).any(-1).any(0)
            assert not (changed & ~allowed).any()
            assert all(changed[p, o] for p, o in new)


def test_checkpointed_row_reverts_to_the_scratch_page():
    eng = _llama_engine(max_batch=2)
    for rid, n in enumerate((9, 30)):
        eng.submit(EngineRequest(rid=rid, tokens=list(range(1, n + 1)),
                                 prompt_len=n, max_new_tokens=8))
    eng.step()
    table, lens = eng.cache.table_view()
    assert table[1, :8].tolist() != [eng.cache.scratch] * 8
    eng.checkpoint_request(1)
    assert (table[1] == eng.cache.scratch).all() and lens[1] == 1
    eng.step()                       # the step's device view follows
    view = eng._view
    assert (view["block_tables"][1] == eng.cache.scratch).all()
    assert view["context_lens"].tolist() == [lens[0], 1]
    assert (view["block_tables"][0] == torch.from_numpy(table[0])).all()


def test_slot_reserved_by_chunked_staging_stays_on_the_scratch_page():
    """rid 1 finishes in slot 1 while rid 0 decodes on; rid 2 is then
    staged into slot 1 over three steps, each of which decodes slot 0 and
    pads slot 1."""
    eng = _llama_engine(max_batch=2, prefill_chunk=4)
    for rid, (n, m) in enumerate(((3, 12), (3, 2), (14, 2))):
        eng.submit(EngineRequest(rid=rid, tokens=list(range(1, n + 1)),
                                 prompt_len=n, max_new_tokens=m))
    table, lens = eng.cache.table_view()
    staged = 0
    while eng.load:
        eng.step()
        if eng._staging is not None:
            staged += 1
            assert eng._staging["slot"] == 1 and eng.slots[1] is None
            assert eng.slots[0] is not None        # row 0 decoded
            assert (table[1] == eng.cache.scratch).all() and lens[1] == 1
            assert (eng._view["block_tables"][1] == eng.cache.scratch).all()
    assert staged == 3                # 14 tokens in chunks of 4: 3 of 4
    assert [r.rid for r in eng.completed] == [1, 2, 0]


@pytest.mark.parametrize("max_len", [17, 64, 100])
def test_table_view_has_the_fixed_width_whatever_the_lengths(max_len):
    cfg = reduce_config(get_config("llama3.1-8b"))
    cache = PagedKVCache(cfg, num_pages=64, page_size=PAGE, slots=3,
                         max_len=max_len, device="cpu")
    width = -(-max_len // PAGE)
    table, lens = cache.table_view()
    assert table.shape == (3, width) and table.dtype == np.int32
    assert (table == cache.scratch).all() and lens.tolist() == [1, 1, 1]
    assert cache.take_changed_rows() == [0, 1, 2]
    cache.allocate(0, 1)
    cache.allocate(2, max_len - 1)
    cache.extend(2, 1)
    assert cache.table_view()[0].shape == (3, width)
    assert cache.take_changed_rows() == [0, 2]
    assert lens.tolist() == [1, 1, max_len]
    assert (table[0, 1:] == cache.scratch).all()
    assert (table[1] == cache.scratch).all()
    assert cache.scratch not in table[2].tolist()
    used = table[2].tolist() + [int(table[0, 0])]
    assert len(set(used)) == len(used)
    with pytest.raises(ValueError):
        cache.extend(2, PAGE)                     # past the table's width
    cache.extend(0, 1)
    assert cache.take_changed_rows() == []        # a length, not a row
    cache.release(2)
    assert (table[2] == cache.scratch).all() and lens[2] == 1
    assert cache.utilization() == pytest.approx(1 / 64)


@pytest.mark.parametrize("windows", [None, (16, 8)])
def test_step_calls_the_paged_kernel_once_per_attention_layer(monkeypatch,
                                                              windows):
    """One decode step of reduced gemma3-27b (1 full layer, 7 window
    layers) calls the paged kernel 8 times, what the card's graph records
    and each replay counts: with one window size as before the ring
    stacks (its one stack the cache's own tensors), and with window layers
    of 16 and 8 over two stacks."""
    _, tcfg, _, model = _bridged("gemma3-27b" if windows is None
                                 else "gemma3-27b-mixed", 2)
    eng = InferenceEngine(tcfg, model, max_batch=3, max_len=MAX_LEN,
                          page_size=PAGE, device="cpu")
    calls = []
    real = TL.paged_attention
    monkeypatch.setattr(TL, "paged_attention",
                        lambda *a: calls.append(a[2].shape) or real(*a))
    eng._decode_body()
    assert len(calls) == 8
    stacks = eng._view["win_stacks"]
    if windows is None:
        (k, v, tables, size), = stacks
        (ring,) = eng.window.stacks
        assert k is ring.k and v is ring.v
        assert tables is ring.tables and size == 16
        assert k.shape == (7, 3 * 16 // PAGE, PAGE, 1, tcfg.head_dim)
    else:
        assert [st[3] for st in stacks] == [16, 8]
        assert [st[0].shape[0] for st in stacks] == [4, 3]
    assert calls.count(eng.cache.k_pages.shape[1:]) == 1
