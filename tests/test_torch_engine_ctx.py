"""The port's engine under a mesh (``InferenceEngine(..., ctx=)``) at one
gloo rank against the JAX engine under a ctx, on bridged weights.

Under an enabled ctx the port's engine holds the reference's ring cache
(``init_cache(..., ring=True)`` placed by
``distributed.sharding.place_cache``), admits a prompt through
``prefill(ctx=)`` or ``prefill_chunk(ctx=)`` and copies it into its slot
(``splice_ring``), and decodes every slot at once through
``ring_decode_step(ctx=)``.  The JAX engine runs on a 1 x 1 mesh
of ``Auto`` axes (the installed JAX's ``make_local_mesh`` gives
``Explicit`` axes, which the reference cannot run under: a pinned
departure).  Reduced llama3.1-8b, gemma3-27b (window 16, and windows 16
and 8 in turn), deepseek-v2-lite-16b (MLA, the MoE ``local_map`` branch)
and mamba2-1.3b (the SSD scan under ``local_map``), fp32: greedy tokens
must be equal, one-shot and, where the config is chunkable, in chunks of
8, the window rings wrapping.  Also a checkpoint and resume under the
ctx, a mesh on another device than the engine's, and ``ctx=NULL_CTX``
giving today's engine.
"""
import functools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduce_config as jax_reduce  # noqa: E402
from repro.distributed.context import ShardCtx as JCtx  # noqa: E402
from repro.engine.engine import EngineRequest as JReq  # noqa: E402
from repro.engine.engine import InferenceEngine as JEngine  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.distributed.context import NULL_CTX, ShardCtx  # noqa: E402
from repro_torch.engine.engine import (EngineRequest,  # noqa: E402
                                       InferenceEngine)
from repro_torch.engine.kv_cache import PagedKVCache  # noqa: E402
from repro_torch.engine.window_cache import WindowCache  # noqa: E402
from repro_torch.launch.serve import alternate_windows  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import ssd as TSSD  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402

MAX_BATCH, MAX_LEN, MAX_NEW = 3, 40, 6
WINDOWS = (16, 8)          # "gemma3-27b windows": its window layers in turn
# (config, chunk): every config one-shot, the chunkable ones in chunks too
CASES = [("llama3.1-8b", None), ("llama3.1-8b", 8), ("gemma3-27b", None),
         ("gemma3-27b", 8), ("gemma3-27b windows", None),
         ("gemma3-27b windows", 8), ("deepseek-v2-lite-16b", None),
         ("mamba2-1.3b", None)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread per test module: the tier-1 run's workers share the
    host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ctxs():
    """(the port's ctx over a 1 x 1 gloo mesh, the JAX ctx over a 1 x 1
    mesh of ``Auto`` axes)."""
    import torch.distributed as dist
    from repro_torch.launch import sharded as SH
    SH.start_world(device="cpu")
    jmesh = jax.make_mesh((1, 1), ("data", "model"),
                          axis_types=(AxisType.Auto,) * 2)
    yield (SH.mesh_ctx(1, 1, device="cpu"),
           JCtx(mesh=jmesh, data_axes=("data",)))
    dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def _bridged(name: str):
    arch = name.split()[0]
    jcfg, tcfg = jax_reduce(jax_get_config(arch)), reduce_config(
        get_config(arch))
    if name.endswith("windows"):
        jcfg, tcfg = (alternate_windows(c, WINDOWS) for c in (jcfg, tcfg))
    params = JM.init_params(jcfg, jax.random.PRNGKey(4), dtype=jnp.float32)
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                            device="cpu")
    return jcfg, tcfg, params, model


def _prompts(vocab: int):
    """Five prompts over three slots, 6 to 21 tokens: with 6 new tokens
    the 16-row and 8-row window rings wrap."""
    rng = np.random.default_rng(2)
    return [[int(t) for t in rng.integers(0, vocab, n)]
            for n in (13, 6, 21, 9, 17)]


def _serve(eng, req_cls, prompts):
    for rid, p in enumerate(prompts):
        eng.submit(req_cls(rid=rid, tokens=list(p), prompt_len=len(p),
                           max_new_tokens=MAX_NEW))
    return {r.rid: r.generated for r in eng.run_until_drained()}


@pytest.mark.parametrize("name,chunk", CASES)
def test_engine_under_mesh_matches_jax_engine(name, chunk, ctxs):
    ctx, jctx = ctxs
    jcfg, tcfg, params, model = _bridged(name)
    prompts = _prompts(tcfg.vocab_size)
    eng = InferenceEngine(tcfg, model, max_batch=MAX_BATCH, max_len=MAX_LEN,
                          ctx=ctx, prefill_chunk=chunk, device="cpu")
    assert eng.prefill_chunk == chunk
    assert eng.cache is eng.window is eng.latent is eng.states is None
    got = _serve(eng, EngineRequest, prompts)
    want = _serve(JEngine(jcfg, params, max_batch=MAX_BATCH, max_len=MAX_LEN,
                          ctx=jctx, prefill_chunk=chunk), JReq, prompts)
    assert got == want and len(got) == 5
    assert all(len(g) == MAX_NEW for g in got.values())
    # the caller's model stays plain; the engine holds a placed copy
    assert not TL._is_dtensor(model.top["embed"])
    assert TL._is_dtensor(eng.params.top["embed"])


def _checkpoint_run(src, dst, req_cls):
    """Ten tokens on ``src``, two steps, a checkpoint, then the rest on
    ``dst``: the snapshot's generated tokens."""
    src.submit(req_cls(rid=99, tokens=list(range(10)), prompt_len=10,
                       max_new_tokens=8))
    src.step()
    src.step()
    snap = src.checkpoint_request(99)
    assert snap.tokens[:10] == list(range(10)) and len(snap.tokens) == 13
    assert all(s is None for s in src.slots)
    dst.submit(snap)
    dst.run_until_drained()
    return snap.generated


@pytest.mark.parametrize("chunk", [None, 4])
def test_checkpoint_and_resume_under_mesh_match_jax_one_shot(chunk, ctxs):
    """A request checkpointed after three generated tokens on a one-shot
    engine under the ctx resumes on another (one-shot, or in chunks of 4:
    the port prefills every token a request holds) with the JAX one-shot
    engine's tokens under its ctx."""
    ctx, jctx = ctxs
    jcfg, tcfg, params, model = _bridged("llama3.1-8b")

    def port(c=None):
        return InferenceEngine(tcfg, model, max_batch=2, max_len=48, ctx=ctx,
                               prefill_chunk=c, device="cpu")

    def ref():
        return JEngine(jcfg, params, max_batch=2, max_len=48, ctx=jctx)
    got = _checkpoint_run(port(), port(chunk), EngineRequest)
    want = _checkpoint_run(ref(), ref(), JReq)
    assert got == want and len(got) == 8


def test_mesh_on_another_device_raises():
    _, tcfg, _, model = _bridged("llama3.1-8b")
    ctx = ShardCtx(mesh=SimpleNamespace(device_type="cuda"))
    with pytest.raises(ValueError, match="mesh on cuda, engine on cpu"):
        InferenceEngine(tcfg, model, ctx=ctx, device="cpu")


def _kernel_calls(monkeypatch):
    """Calls of each kernel wrapper, counted where the layers call them
    (on the CPU the wrappers count no launches: they run no kernel)."""
    calls = {"flash_attention": 0, "paged_attention": 0, "ssd": 0}
    for mod, name in ((TL, "flash_attention"), (TL, "paged_attention"),
                      (TSSD, "ssd")):
        real = getattr(mod, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.mark.parametrize("name,chunk", [("gemma3-27b", None),
                                        ("gemma3-27b", 8),
                                        ("mamba2-1.3b", None)])
def test_null_ctx_gives_todays_engine(name, chunk, monkeypatch, ctxs):
    """``ctx=NULL_CTX`` builds the engine that no ``ctx`` builds: the same
    caches, buffers, kernel calls and tokens.  Under a ctx the decode
    step calls no paged kernel (the ring is read by the plain ``_sdpa``),
    and prefill calls flash or ssd once per attention or mamba layer per
    prefill call."""
    ctx, _ = ctxs
    _, tcfg, _, model = _bridged(name)
    prompts = _prompts(tcfg.vocab_size)
    runs = []
    for kw in ({}, {"ctx": NULL_CTX}, {"ctx": ctx}):
        calls = _kernel_calls(monkeypatch)
        eng = InferenceEngine(tcfg, model, max_batch=MAX_BATCH,
                              max_len=MAX_LEN, prefill_chunk=chunk,
                              device="cpu", **kw)
        kinds = tuple(type(c).__name__ for c in (eng.cache, eng.window,
                                                eng.latent, eng.states))
        out = _serve(eng, EngineRequest, prompts)
        runs.append((kinds, tuple(eng._host.shape), dict(calls), out,
                     sum(k == "decode" for k, _, _ in eng.events)))
        monkeypatch.undo()
    (kinds, host, calls, out, steps), null, sharded = runs
    assert null == runs[0]
    if name == "gemma3-27b":
        assert kinds[:2] == (PagedKVCache.__name__, WindowCache.__name__)
    assert sharded[0] == ("NoneType",) * 4 and sharded[3] == out
    layers = tcfg.num_layers
    prefill_calls = len(prompts) if chunk is None else sum(
        -(-len(p) // chunk) for p in prompts)
    kernel = "ssd" if name.startswith("mamba") else "flash_attention"
    assert sharded[2] == {"flash_attention": 0, "paged_attention": 0,
                          "ssd": 0, kernel: layers * prefill_calls}
    assert calls[kernel] == layers * prefill_calls
    if kernel == "flash_attention":
        assert calls["paged_attention"] == layers * steps
