"""The engine's spans (``engine.trace``) on the CPU: one request's spans
share its rid, ``decode``'s children tile it, the drained events keep their
contract and equal their spans, the buffer is bounded, the engine
synchronises as often as it did before it had spans, and a span placed on
the profiler's clock holds the profiler's own events."""
import time
from collections import Counter

import pytest

torch = pytest.importorskip("torch")

import repro_torch.engine.engine as E  # noqa: E402
import repro_torch.engine.trace as T  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.engine.engine import EngineRequest, InferenceEngine  # noqa: E402
from repro_torch.engine.trace import Tracer  # noqa: E402

CFG = reduce_config(get_config("llama3.1-8b"))
SIZES = (5, 20, 11)                 # prompt lengths
CHUNKS = {"one_shot": None, "chunked": 8}
# device synchronises per step for SIZES on two slots, counted on the engine
# before it had spans: admission and decode each synchronise where they did
SYNCS = {"one_shot": [6, 2, 2, 4, 2, 2, 0],
         "chunked": [4, 3, 2, 3, 3, 3, 2, 2, 0]}


@pytest.fixture(scope="module")
def model():
    torch.set_num_threads(1)
    return InferenceEngine(CFG, max_batch=1, max_len=32, device="cpu").params


def _engine(model, kind, max_new=4):
    eng = InferenceEngine(CFG, model, max_batch=2, max_len=64, device="cpu",
                          prefill_chunk=CHUNKS[kind])
    for rid, n in enumerate(SIZES):
        p = list(range(3, 3 + n))
        eng.submit(EngineRequest(rid=rid, tokens=p, prompt_len=n,
                                 max_new_tokens=max_new))
    return eng


def _served(model, kind):
    eng = _engine(model, kind)
    events = []
    while True:
        n = eng.step()
        events += eng.drain_events()
        if n == 0 and not eng.queue and eng._staging is None:
            return eng, events


@pytest.mark.parametrize("kind", CHUNKS)
def test_spans_of_one_request_share_its_rid(model, kind):
    eng, _ = _served(model, kind)
    recs = eng.trace.records()
    by_sid = {r.sid: r for r in recs}
    for rid, n in enumerate(SIZES):
        mine = [r for r in recs if r.rid == rid]
        names = Counter(r.name for r in mine)
        assert names["queued"] == names["prefill"] == 1
        queued, pre = (next(r for r in mine if r.name == k)
                       for k in ("queued", "prefill"))
        assert queued.t1 == pre.t0          # admission starts where it waits
        calls = [r for r in mine if r.name == "prefill.call"]
        assert all(by_sid[c.parent] is pre for c in calls)
        assert sum(c.attrs["tokens"] for c in calls) == n
        assert len(calls) == (1 if kind == "one_shot" else -(-n // 8))
        assert calls[0].t0 == pre.t0 and calls[-1].t1 == pre.t1
        # the calls follow each other; decode steps may come between
        assert all(a.t1 <= b.t0 for a, b in zip(calls, calls[1:]))
    assert {r.name for r in recs if r.rid is None} <= {
        "decode", "decode.fill", "decode.launch", "decode.wait",
        "decode.readback"}


@pytest.mark.parametrize("kind", CHUNKS)
def test_decode_children_tile_it(model, kind):
    eng, _ = _served(model, kind)
    recs = eng.trace.records()
    decodes = [r for r in recs if r.name == "decode"]
    assert decodes
    for d in decodes:
        kids = sorted((r for r in recs if r.parent == d.sid),
                      key=lambda r: r.t0)
        assert [k.name for k in kids] == ["decode.fill", "decode.launch",
                                          "decode.wait", "decode.readback"]
        assert kids[0].t0 == d.t0 and kids[-1].t1 == d.t1
        assert all(a.t1 == b.t0 for a, b in zip(kids, kids[1:]))
        assert sum(k.dt for k in kids) == pytest.approx(d.dt, rel=0.01)
        assert d.attrs["pool"] == eng.cache.num_pages
        assert 0 < d.attrs["pages"] <= d.attrs["pool"]
        assert 0 < d.attrs["rows"] <= 2


@pytest.mark.parametrize("kind", CHUNKS)
def test_each_event_equals_its_span(model, kind):
    eng, events = _served(model, kind)
    recs = eng.trace.records()
    pre = sorted((r for r in recs if r.name == "prefill"),
                 key=lambda r: r.t1)
    assert [e[2] for e in events if e[0] == "prefill"] == [r.dt for r in pre]
    # a decode event times its span up to the end of its wait
    waits = {r.parent: r for r in recs if r.name == "decode.wait"}
    dec = sorted((r for r in recs if r.name == "decode"), key=lambda r: r.t0)
    assert [e[2] for e in events if e[0] == "decode"] == \
        [waits[d.sid].t1 - d.t0 for d in dec]
    assert [e[1] for e in events if e[0] == "decode"] == \
        [d.attrs["rows"] for d in dec]


@pytest.mark.parametrize("kind", CHUNKS)
def test_drained_events_keep_their_contract(model, kind):
    _, events = _served(model, kind)
    assert events and all(type(e) is tuple and len(e) == 3 for e in events)
    assert {e[0] for e in events} == {"prefill", "decode"}
    assert sum(e[0] == "prefill" for e in events) == len(SIZES)


def test_buffer_is_bounded_and_counts_drops(monkeypatch):
    monkeypatch.setattr(T, "MAX_RECORDS", 4)
    tr = Tracer()
    for i in range(10):
        tr.close(tr.open("s", float(i), rid=i), i + 0.5)
    recs = tr.records()
    assert len(recs) == 4 and tr.dropped == 6
    assert [r.rid for r in recs] == [6, 7, 8, 9]


@pytest.mark.parametrize("kind", CHUNKS)
def test_synchronises_per_step_as_before(model, kind, monkeypatch):
    eng = _engine(model, kind)
    calls = [0]
    real = E.synchronize

    def counted(device):
        calls[0] += 1
        real(device)
    monkeypatch.setattr(E, "synchronize", counted)
    per = []
    for _ in range(40):
        calls[0] = 0
        n = eng.step()
        per.append(calls[0])
        if n == 0 and not eng.queue and eng._staging is None:
            break
    assert per == SYNCS[kind]


def test_checkpointed_queued_request_leaves_no_span(model):
    eng = _engine(model, "one_shot")
    assert eng.checkpoint_request(2) is not None
    eng.run_until_drained()
    assert all(r.rid != 2 for r in eng.trace.records())
    assert not eng._queued


def test_mapping_takes_the_nearest_pair():
    tr = Tracer()
    tr._pairs.clear()
    tr._pairs.extend([(1_000_000_000, 5_000_000_000),
                      (3_000_000_000, 7_000_000_100)])
    assert tr.to_unix_ns(1.5) == 5_500_000_000
    assert tr.to_unix_ns(2.5) == 6_500_000_100
    assert tr.to_unix_ns(9.0) == 13_000_000_100


def test_a_mapped_span_holds_the_profilers_events():
    from torch.profiler import ProfilerActivity, profile
    a = torch.randn(128, 128)
    a @ a
    tr = Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        span = tr.open("work", time.perf_counter())
        a @ a
        tr.close(span, time.perf_counter())
    rec, = tr.records()
    assert rec.profiled
    lo, hi = tr.to_unix_ns(rec.t0), tr.to_unix_ns(rec.t1)
    events = list(prof.profiler.kineto_results.events())
    mm = [e for e in events if e.name() == "aten::mm"]
    assert mm
    for e in mm:
        assert e.start_ns() >= lo - 200_000
        assert e.start_ns() + e.duration_ns() <= hi + 200_000
    note, = [e for e in events if e.name() == "work"]
    assert note.is_user_annotation()
    assert lo - 200_000 <= note.start_ns() <= hi    # entered once opened


def test_engine_spans_under_the_profiler_are_annotations(model):
    from torch.profiler import ProfilerActivity, profile
    eng = _engine(model, "chunked")
    eng.step()                        # queued before the profiler starts
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            eng.step()
    notes = Counter(e.name() for e in prof.profiler.kineto_results.events()
                    if e.is_user_annotation())
    assert {"decode", "decode.fill", "decode.launch", "decode.wait",
            "decode.readback", "prefill.call"} <= set(notes)
    assert "queued" not in notes and "prefill" not in notes
    recs = eng.trace.records()
    assert notes["decode"] == sum(r.profiled for r in recs
                                  if r.name == "decode") == 3
    assert not any(r.profiled for r in recs if r.name == "queued")


@pytest.mark.parametrize("arch", ["granite-4.0-h-small", "mamba2-1.3b",
                                  "llama3.1-8b"])
def test_one_state_span_per_admission_of_a_mamba_engine(arch):
    """A config with mamba layers records one ``prefill.state`` a one-shot
    admission, a child of its ``prefill.call``, with the bytes written:
    the mamba layers x (the f32 state + the conv history); a config
    without them records none."""
    torch.set_num_threads(1)
    cfg = reduce_config(get_config(arch))
    eng = InferenceEngine(cfg, max_batch=2, max_len=64, device="cpu")
    for rid, n in enumerate(SIZES):
        eng.submit(EngineRequest(rid=rid, tokens=list(range(3, 3 + n)),
                                 prompt_len=n, max_new_tokens=3))
    eng.run_until_drained()
    recs = eng.trace.records()
    states = [r for r in recs if r.name == "prefill.state"]
    n_mamba = sum(b.mixer == "mamba" for b in cfg.layer_list())
    if not n_mamba:
        assert states == []
        return
    calls = {r.sid: r for r in recs if r.name == "prefill.call"}
    assert sorted(r.rid for r in states) == list(range(len(SIZES)))
    s = cfg.ssm
    di, gn = s.d_inner(cfg.d_model), s.n_groups * s.d_state
    per_layer = (s.n_heads(cfg.d_model) * s.head_dim * s.d_state * 4
                 + (s.d_conv - 1) * (di + 2 * gn) * 4)     # fp32 weights
    for r in states:
        assert r.attrs == {"bytes": n_mamba * per_layer}
        call = calls[r.parent]
        assert call.rid == r.rid and call.t0 <= r.t0 <= r.t1 <= call.t1
        assert not r.profiled
