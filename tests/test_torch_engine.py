"""The port's serving engine against the JAX engine on bridged weights:
greedy tokens must be identical one-shot and chunked, across a checkpoint
round trip; plus the paged allocator, the bounded events ring, and the
CPU run of the serving launcher."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduce_config as jax_reduce  # noqa: E402
from repro.engine.engine import EngineRequest as JReq  # noqa: E402
from repro.engine.engine import InferenceEngine as JEngine  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.engine.engine import EngineRequest, InferenceEngine  # noqa: E402
from repro_torch.engine.kv_cache import PagedKVCache  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402


@pytest.fixture(scope="module")
def bridged():
    jcfg = jax_reduce(jax_get_config("llama3.1-8b"))
    tcfg = reduce_config(get_config("llama3.1-8b"))
    params = jax_init_params(jcfg, jax.random.PRNGKey(5), dtype=jnp.float32)
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                            device="cpu")
    return jcfg, tcfg, params, model


def _port(bridged, **kw):
    _, tcfg, _, model = bridged
    return InferenceEngine(tcfg, model, device="cpu", **kw)


def _jax(bridged, **kw):
    jcfg, _, params, _ = bridged
    return JEngine(jcfg, params, **kw)


def _serve(eng, req_cls, prompts, max_new=6):
    for rid, p in enumerate(prompts):
        eng.submit(req_cls(rid=rid, tokens=list(p), prompt_len=len(p),
                           max_new_tokens=max_new))
    return {r.rid: r.generated for r in eng.run_until_drained()}


def test_batched_requests_match_jax_engine(bridged):
    prompts = [list(range(5 + i, 13 + i)) for i in range(5)]
    port = _port(bridged, max_batch=3, max_len=64)
    got = _serve(port, EngineRequest, prompts)
    want = _serve(_jax(bridged, max_batch=3, max_len=64), JReq, prompts)
    assert got == want and len(got) == 5
    assert port.cache.utilization() == 0.0      # every page released


def test_chunked_prefill_matches_jax_engine(bridged):
    rng = np.random.default_rng(1)
    prompts = [[int(x) for x in rng.integers(0, 256, n)] for n in (17, 9)]
    chk = _port(bridged, max_batch=2, max_len=64, prefill_chunk=8)
    assert chk.prefill_chunk == 8
    got = _serve(chk, EngineRequest, prompts)
    one = _serve(_port(bridged, max_batch=2, max_len=64), EngineRequest,
                 prompts)
    want = _serve(_jax(bridged, max_batch=2, max_len=64), JReq, prompts)
    assert got == one == want


def test_checkpoint_roundtrip_releases_pages(bridged):
    def run(make, req_cls):
        src, dst = make(), make()
        src.submit(req_cls(rid=99, tokens=list(range(10)), prompt_len=10,
                           max_new_tokens=8))
        src.step()
        src.step()
        snap = src.checkpoint_request(99)
        assert snap.tokens[:10] == list(range(10)) and len(snap.tokens) == 13
        dst.submit(snap)
        dst.run_until_drained()
        return src, snap.generated

    src, got = run(lambda: _port(bridged, max_batch=2, max_len=48),
                   EngineRequest)
    assert src.cache.utilization() == 0.0 and not src.cache.tables
    assert all(s is None for s in src.slots)
    _, want = run(lambda: _jax(bridged, max_batch=2, max_len=48), JReq)
    assert got == want and len(got) == 8


def test_chunked_resume_after_checkpoint_matches_jax_one_shot(bridged):
    """A request checkpointed after three generated tokens resumes on a
    chunked-prefill port engine with the tokens of the JAX one-shot
    engine.  The JAX chunked engine is not the oracle here: its chunked
    path prefills only ``prompt_len`` tokens and splices the cache there
    (``repro/engine/engine.py:162-174``), so it drops the generated
    tokens' K/V and generates again from the end of the prompt.  The port
    prefills every token a request holds, on both paths."""
    def snapshot(src, req_cls):
        src.submit(req_cls(rid=99, tokens=list(range(10)), prompt_len=10,
                           max_new_tokens=8))
        src.step()
        src.step()
        snap = src.checkpoint_request(99)
        assert len(snap.generated) == 3
        return snap

    dst = _port(bridged, max_batch=2, max_len=48, prefill_chunk=4)
    assert dst.prefill_chunk == 4
    dst.submit(snapshot(_port(bridged, max_batch=2, max_len=48),
                        EngineRequest))
    got = dst.run_until_drained()[0].generated
    one_shot = _jax(bridged, max_batch=2, max_len=48)
    one_shot.submit(snapshot(_jax(bridged, max_batch=2, max_len=48), JReq))
    want = one_shot.run_until_drained()[0].generated
    assert got == want == [88, 119, 245, 245, 245, 30, 244, 132]
    assert dst.cache.utilization() == 0.0


def test_checkpoint_of_staged_and_queued_requests(bridged):
    eng = _port(bridged, max_batch=1, max_len=48, prefill_chunk=4)
    for rid in range(2):
        eng.submit(EngineRequest(rid=rid, tokens=list(range(1, 11)),
                                 prompt_len=10, max_new_tokens=3))
    eng.step()                                  # rid 0 staged, one chunk in
    assert eng.checkpoint_request(0).rid == 0 and eng._staging is None
    assert eng.checkpoint_request(1).rid == 1 and not eng.queue
    assert eng.checkpoint_request(7) is None
    assert eng.cache.utilization() == 0.0


def test_drain_events_bounded_and_clearing(bridged):
    eng = _port(bridged, max_batch=2, max_len=48, max_events=4)
    for i in range(3):
        eng.submit(EngineRequest(rid=i, tokens=list(range(2, 9)),
                                 prompt_len=7, max_new_tokens=6))
    eng.run_until_drained()
    assert len(eng.events) <= 4
    ev = eng.drain_events()
    assert 0 < len(ev) <= 4
    assert all(kind in ("prefill", "decode") and dt >= 0
               for kind, _, dt in ev)
    assert eng.drain_events() == []


def test_submit_rejects_prompt_past_max_len(bridged):
    eng = _port(bridged, max_batch=1, max_len=16)
    with pytest.raises(ValueError):
        eng.submit(EngineRequest(rid=0, tokens=list(range(16)),
                                 prompt_len=16))


def test_paged_cache_allocator():
    cfg = reduce_config(get_config("llama3.1-8b"))
    cache = PagedKVCache(cfg, num_pages=16, page_size=8, device="cpu")
    cache.allocate(1, 20)             # 3 pages
    cache.allocate(2, 8)              # 1 page
    assert cache.utilization() == pytest.approx(4 / 16)
    cache.extend(1, 5)                # 25 tokens -> 4 pages
    assert len(cache.tables[1]) == 4
    bt, lens = cache.batch_tables([1, 2])
    assert tuple(bt.shape) == (2, 4) and bt.dtype == torch.int32
    assert lens.tolist() == [25, 8]
    cache.release(1)
    assert cache.utilization() == pytest.approx(1 / 16)
    with pytest.raises(MemoryError):
        cache.allocate(3, 16 * 8 + 1)


def test_paged_cache_exhaustion_on_extend():
    cfg = reduce_config(get_config("llama3.1-8b"))
    cache = PagedKVCache(cfg, num_pages=2, page_size=8, device="cpu")
    cache.allocate(1, 16)
    with pytest.raises(MemoryError):
        cache.extend(1, 1)


def test_paged_cache_batched_write_lands_in_its_pages():
    cfg = reduce_config(get_config("llama3.1-8b"), layers_per_stage=2)
    cache = PagedKVCache(cfg, num_pages=8, page_size=4, dtype=torch.float32,
                         device="cpu")
    cache.allocate(0, 6)
    k = torch.arange(6 * 16, dtype=torch.float32).reshape(6, 1, 16)
    cache.write(1, cache.token_index(0, 0, 6), k, -k)
    pages = cache.tables[0]
    for pos in range(6):
        row = cache.k_pages[1, pages[pos // 4], pos % 4]
        assert torch.equal(row, k[pos])
        assert torch.equal(cache.v_pages[1, pages[pos // 4], pos % 4], -k[pos])
    assert not cache.k_pages[0].any()         # other layers untouched


def test_serve_launcher_reduced_on_cpu(capsys):
    from repro_torch.launch.serve import main
    report = main(["--device", "cpu", "--size", "reduced",
                   "--n-requests", "6", "--max-new", "4"])
    engines = report["engines"]
    assert sum(len(e.completed) for e in engines) == 6
    assert all(len(e.completed) == 3 for e in engines)   # routed by load
    assert engines[1].prefill_chunk == 8 and engines[0].prefill_chunk is None
    assert engines[0].params is engines[1].params       # one weight set
    assert all(k in ("prefill", "decode") for ev in report["events"]
               for k, _, _ in ev)
    assert "served 6 requests" in capsys.readouterr().out


def test_profile_summary_merges_overlapping_kernels():
    from repro_torch.launch.profile_step import _summary
    kernels = [("gemm", 0.0, 10.0), ("attn", 5.0, 10.0), ("gemm", 30.0, 5.0)]
    s = _summary("decode", kernels, wall_s=50e-6, steps=1)
    assert s["device_busy_ms"] == pytest.approx(0.020)     # 0-15 and 30-35
    assert s["device_idle_share"] == pytest.approx(0.6)
    assert s["launches_per_step"] == 3
    assert list(s["device_ms_by_kernel"]) == ["gemm", "attn"]


def test_profile_summary_counts_the_port_kernels():
    from repro_torch.launch.profile_step import _summary
    split = "void (anonymous namespace)::paged_split_mma_kernel<128>(int)"
    merge = "void (anonymous namespace)::paged_merge_kernel<float>(int)"
    torch_own = "void at::native::(anonymous namespace)::silu_kernel(int)"
    kernels = [(split, 0.0, 8.0), (merge, 9.0, 2.0), ("sm90_gemm", 12.0, 20.0),
               (torch_own, 33.0, 1.0), (split, 40.0, 8.0), (merge, 49.0, 2.0)]
    s = _summary("decode", kernels, wall_s=100e-6, steps=2)
    assert s["port_kernels"] == {
        "paged_merge_kernel": {"ms_per_step": pytest.approx(0.002),
                               "launches_per_step": 1.0},
        "paged_split_mma_kernel": {"ms_per_step": pytest.approx(0.008),
                                   "launches_per_step": 1.0}}


def test_profile_summary_counts_plain_port_kernels():
    """A kernel that is no template instance is traced without its return
    type; it is one of the port's kernels all the same.  A kernel that no
    source of the port defines is not, whatever its namespace."""
    from repro_torch.launch.profile_step import _summary
    chunk = "void (anonymous namespace)::ssd_chunk_kernel<__nv_bfloat16>(int)"
    state = "(anonymous namespace)::ssd_state_pass_kernel(float*, int)"
    scan = "(anonymous namespace)::ssd_scan_mma_kernel(float const*, int)"
    torch_own = "at::native::(anonymous namespace)::silu_kernel(int)"
    # PyTorch's own kernel in a top-level anonymous namespace
    torch_anon = ("void (anonymous namespace)::elementwise_kernel_with_index"
                  "<int>(int)")
    kernels = [(chunk, 0.0, 3.0), (state, 4.0, 1.0), (scan, 6.0, 12.0),
               (torch_own, 20.0, 1.0), (torch_anon, 22.0, 1.0)]
    s = _summary("prefill", kernels, wall_s=40e-6, steps=1)
    assert sorted(s["port_kernels"]) == ["ssd_chunk_kernel", "ssd_scan_mma_kernel",
                                         "ssd_state_pass_kernel"]
    assert s["port_kernels"]["ssd_scan_mma_kernel"]["ms_per_step"] == \
        pytest.approx(0.012)
