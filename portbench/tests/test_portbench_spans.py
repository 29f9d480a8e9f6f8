"""The readers of the program's spans (``engine.trace``) on hand-made
spans, each value worked by hand; a program without spans reads None."""
import types

import pytest

pytest.importorskip("torch")

import portbench_testkit as K  # noqa: E402
from pb import spec  # noqa: E402
from pb.counts import Counts  # noqa: E402
from pb.runner import RunRecord  # noqa: E402
from pb.trace import TraceSummary  # noqa: E402
from repro_torch.engine.trace import Tracer  # noqa: E402

MINICPM = spec.load_cell(K.ROOT, "minicpm-2b.agentic").config
OFFSET = 10 ** 12          # the trace's clock less the host's, in ns
NEW = ("queue_wait_ms", "prefill_work_ms_per_ktok", "prefill_busy",
       "prefill_busy.moe", "decode_host_ms", "decode_host_ms.moe",
       "kv_page_use")


def _tracer(spans):
    """spans: (sid, name, t0, t1, rid, parent, attrs, profiled)."""
    tr = Tracer()
    tr._pairs.clear()
    tr._pairs.append((0, OFFSET))
    tr._records.extend(spans)
    return tr


def _run(engines, trace=None):
    loop = types.SimpleNamespace(engines=engines, tracked=[], events=[],
                                 steps=[], waits=[])
    return RunRecord(cell=None, counts=Counts.of(MINICPM), loop=loop,
                     t_w=10.0, t_end=20.0, setup_s=3.0, trace=trace)


def _decode(sid, t0, t1, wait, pages, pool=100, profiled=False):
    """A decode span and its wait child [wait[0], wait[1])."""
    return [(sid, "decode", t0, t1, None, None,
             {"rows": 4, "pages": pages, "pool": pool}, profiled),
            (sid + 1, "decode.wait", wait[0], wait[1], None, sid, None,
             profiled)]


def _engines():
    e0 = _tracer([
        (1, "queued", 8.0, 11.0, 1, None, None, False),
        (2, "queued", 12.0, 12.5, 2, None, None, False),
        (3, "queued", 5.0, 9.0, 3, None, None, False),       # before
        (4, "queued", 19.0, 21.0, 4, None, None, False),     # after
        (8, "queued", 15.0, 18.0, 5, None, None, True),      # profiled
        (5, "prefill.call", 11.0, 11.1, 1, 9, {"tokens": 500}, True),
        (6, "prefill.call", 12.5, 12.6, 2, 9, {"tokens": 300}, False),
        (7, "prefill.call", 9.0, 9.5, 3, 9, {"tokens": 900}, True),
        (10, "prefill.call", 13.5, 13.8, 5, 9, {"tokens": 500}, False),
        (11, "prefill.call", 7.0, 7.2, 6, 9, {"tokens": 500}, False),
        *_decode(20, 5.0, 5.01, (5.002, 5.009), 10),
        *_decode(22, 13.0, 13.010, (13.004, 13.008), 20),
        *_decode(24, 14.0, 14.020, (14.005, 14.015), 30),
        *_decode(26, 20.5, 25.0, (21.0, 24.0), 90),
        *_decode(28, 16.0, 16.030, (16.001, 16.002), 30, profiled=True)])
    e1 = _tracer(_decode(1, 0.0, 0.01, (0.0, 0.005), 50))
    return [types.SimpleNamespace(trace=e0), types.SimpleNamespace(trace=e1)]


def _read(name, run):
    return spec.metric_reader(name).read(run)


def _ns(t):
    return int(round(t * 1e9)) + OFFSET


def test_queue_wait_is_the_p90_of_waits_closed_in_the_window():
    # 3000 and 500 ms: the 90th percentile lies 0.9 of the way up; the
    # wait that opened under the profiler is left out
    assert _read("queue_wait_ms", _run(_engines())) == pytest.approx(2750.0)


def test_prefill_work_sums_calls_over_their_tokens():
    # 0.1 s + 0.3 s over 300 + 500 tokens; the profiled call, the one that
    # closed before the window and those outside it are left out
    assert _read("prefill_work_ms_per_ktok", _run(_engines())) == \
        pytest.approx(0.4 / 800 * 1e6)


def test_decode_host_is_each_span_less_its_wait():
    # (10 - 4) and (20 - 10) ms; engine 1's step, the late one and the
    # profiled one (29 ms of host) are out
    for name in ("decode_host_ms", "decode_host_ms.moe"):
        assert _read(name, _run(_engines())) == pytest.approx(8.0)


def test_kv_page_use_is_a_time_average_over_both_pools():
    # engine 0: 10 pages over 10-13 s, 20 over 13-14, 30 over 14-20 (the
    # profiled step samples 30 again): 23 on average; engine 1: 50
    # throughout; pools of 100 each
    assert _read("kv_page_use", _run(_engines())) == pytest.approx(36.5)


def test_prefill_busy_counts_device_time_inside_profiled_calls():
    # the profiled call in the window covers 11.0-11.1 s; the ops cover
    # 11.00-11.03 (and 11.01-11.02 inside it) and 11.05-11.07: 50 of 100 ms
    ops = [("gemm", _ns(11.0), 30_000_000), ("copy", _ns(11.01), 10_000_000),
           ("gemm", _ns(11.05), 20_000_000), ("late", _ns(11.1), 5_000_000),
           ("early", _ns(10.9), 50_000_000)]
    trace = TraceSummary(ops, 8.0, 0.0, [], [])
    for name in ("prefill_busy", "prefill_busy.moe"):
        assert _read(name, _run(_engines(), trace)) == pytest.approx(50.0)
    assert _read("prefill_busy", _run(_engines())) is None   # no trace
    # one op from 11.05 s past the call's end
    half = TraceSummary([("gemm", _ns(11.05), 60_000_000)], 8.0, 0.0, [], [])
    assert _read("prefill_busy", _run(_engines(), half)) == \
        pytest.approx(50.0)


def test_a_program_without_spans_reads_none():
    ops = [("gemm", _ns(11.0), 30_000_000)]
    run = _run([types.SimpleNamespace(), types.SimpleNamespace()],
               TraceSummary(ops, 8.0, 0.0, [], []))
    for name in NEW:
        assert _read(name, run) is None, name
