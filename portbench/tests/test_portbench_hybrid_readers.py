"""The hybrid cell's readers (``state_write_ms``, ``decode_step_ms.hybrid``,
``mfu.hybrid``, ``ssd_roofline``) on hand-made runs of granite-4.0-h-small's
counts, each value worked by hand; a run without their inputs reads None."""
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


def _read(name, run):
    return spec.metric_reader(name).read(run)


def _ns(t):
    return int(round(t * 1e9)) + OFFSET


# -- granite-4.0-h-small's counts ---------------------------------------------

GRANITE = spec.load_cell(K.ROOT, "granite-4.0-h-small.agentic_saturated").config


def _granite_run(engines=(), events=(), steps=(), trace=None):
    loop = types.SimpleNamespace(engines=list(engines), tracked=[],
                                 events=list(events), steps=list(steps),
                                 waits=[])
    return RunRecord(cell=None, counts=Counts.of(GRANITE), loop=loop,
                     t_w=10.0, t_end=20.0, setup_s=3.0, trace=trace)


def test_state_write_is_the_mean_unprofiled_state_span():
    # 2 and 4 ms; one before the window, one profiled, one after
    tr = _tracer([
        (1, "prefill.state", 11.0, 11.002, 1, 9, {"bytes": 10}, False),
        (2, "prefill.state", 12.0, 12.004, 2, 9, {"bytes": 10}, False),
        (3, "prefill.state", 9.0, 9.5, 3, 9, {"bytes": 10}, False),
        (4, "prefill.state", 13.0, 13.5, 4, 9, {"bytes": 10}, True),
        (5, "prefill.state", 20.5, 20.6, 5, 9, {"bytes": 10}, False)])
    run = _granite_run([types.SimpleNamespace(trace=tr)])
    assert _read("state_write_ms", run) == pytest.approx(3.0)
    assert _read("state_write_ms", _granite_run(
        [types.SimpleNamespace()])) is None                # no spans


def test_hybrid_decode_step_and_mfu_count_the_scan():
    from pb.counts import PEAK_FLOPS
    from pb.loop import StepRec
    c = Counts.of(GRANITE)
    assert (c.mamba_layers(), c.flash_layers()) == (36, 4)
    # (gid, kind, size, dt, t): two decode steps in the window, a prefill
    # of 500 tokens, one decode step after it
    events = [(0, "decode", 16, 0.040, 11.0), (1, "decode", 16, 0.050, 12.0),
              (0, "prefill", 500, 0.120, 13.0), (0, "decode", 16, 9.0, 21.0)]
    steps = [StepRec(0, 11.0, [100] * 16, [], 0),
             StepRec(1, 12.0, [300] * 16, [], 0),
             StepRec(0, 21.0, [300] * 16, [], 0)]
    run = _granite_run(events=events, steps=steps)
    assert _read("decode_step_ms.hybrid", run) == pytest.approx(45.0)
    flops = (c.decode_flops([100] * 16) + c.decode_flops([300] * 16)
             + c.prefill_flops(500))
    assert _read("mfu.hybrid", run) == pytest.approx(
        100 * flops / (0.21 * PEAK_FLOPS))
    # the scan is in: each Mamba layer's update and chunked scan
    scan = 36 * (c.mamba_step(16)[0] * 2 + c.ssd_call(500)[0])
    assert scan > 0 and flops - scan == pytest.approx(
        2 * c.layer_params(True) * (32 + 500) + 2 * c.d * c.vocab * 33
        + c.pair_flops("full") * 4 * (16 * 400 + 500 * 501 // 2))


def test_ssd_roofline_bounds_each_one_shot_prompt_a_mamba_layer():
    from pb.counts import bound_s
    from pb.loop import StepRec
    c = Counts.of(GRANITE)
    name = "void (anonymous namespace)::ssd_chunk_kernel<__nv_bfloat16>(x)"
    ops = [(name, _ns(15.0), 2_000_000),
           ("void (anonymous namespace)::ssd_scan_mma_kernel(y)", _ns(15.1),
            3_000_000),
           ("void (anonymous namespace)::flash_wgmma_kernel<128>(z)",
            _ns(15.2), 9_000_000)]
    trace = TraceSummary(ops, 8.0, 0.0, [], [])
    steps = [StepRec(0, 15.0, [], [(700, 700), (64, 64)], 764, traced=True),
             StepRec(0, 14.0, [], [(900, 900)], 900, traced=False)]
    run = _granite_run(steps=steps, trace=trace)
    want = 36 * (bound_s(*c.ssd_call(700)) + bound_s(*c.ssd_call(64)))
    assert _read("ssd_roofline", run) == pytest.approx(100 * want / 0.005)
    assert _read("ssd_roofline", _granite_run(steps=steps)) is None
    assert _read("ssd_roofline", _run([])) is None           # no Mamba layer
