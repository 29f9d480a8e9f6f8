"""Flop and byte counts of B1, B2 and the model step on shapes worked by
hand, and the end-to-end arithmetic on hand-made request logs."""
import types

import pytest

pytest.importorskip("torch")

import portbench_testkit as K  # noqa: E402
from pb import spec  # noqa: E402
from pb.counts import Counts, bound_s  # noqa: E402
from pb.loop import Tracked  # noqa: E402
from pb.runner import RunRecord  # noqa: E402
from pb.traffic import Request  # noqa: E402

MINICPM = spec.load_cell(K.ROOT, "minicpm-2b.agentic").config
DEEPSEEK = spec.load_cell(K.ROOT, "deepseek-v2-lite-16b.agentic_saturated").config


def test_flash_call_counts_by_hand():
    c = Counts.of(MINICPM)
    # one-shot 4 tokens: 10 causal pairs; H=36, hd=64
    f, b = c.flash_call(4, 4)
    assert f == 4 * 36 * 64 * 10
    assert b == 2 * 64 * (2 * 4 * 36 + 2 * 4 * 36)
    # a chunk of 2 queries over 5 keys: 2 * 3 + 3 = 9 pairs
    f, b = c.flash_call(2, 5)
    assert f == 4 * 36 * 64 * 9
    assert b == 2 * 64 * (2 * 2 * 36 + 2 * 5 * 36)


def test_paged_call_counts_by_hand():
    c = Counts.of(MINICPM)
    f, b = c.paged_call([10, 30])
    assert f == 4 * 36 * 64 * 40
    assert b == 2 * 64 * (2 * 36 * 40 + 2 * 36 * 2)
    # bytes bound: 3.35 TB/s
    assert bound_s(f, b) == pytest.approx(b / 3.35e12)


def test_model_step_counts_by_hand():
    c = Counts.of(MINICPM)
    d, ff, V = 2304, 5760, 122753
    per_layer = 4 * d * d + 3 * d * ff
    assert c.layer_params(True) == 40 * per_layer
    assert c.decode_flops([7]) == 2 * 40 * per_layer + 2 * d * V \
        + 40 * 4 * 36 * 64 * 7
    assert c.prefill_flops(3) == 2 * 40 * per_layer * 3 + 2 * d * V \
        + 40 * 4 * 36 * 64 * 6
    m = Counts.of(DEEPSEEK)
    mla = 2048 * 16 * 192 + 2048 * 576 + 512 * 16 * 128 * 2 + 16 * 128 * 2048
    moe_active = 2048 * 64 + 3 * 2048 * 1408 * 6 + 3 * 2048 * 2816
    assert m.layer_params(True) == 27 * mla + 3 * 2048 * 10944 \
        + 26 * moe_active
    assert m.pair_flops("mla") == 2 * 16 * 192 + 2 * 16 * 128
    assert m.kv_bytes_per_token() == 27 * 576 * 2


def _mamba_counts():
    """d 8, expand 2: di 16 in H = 4 heads of P = 4; G = 1, N = 2, K = 4,
    chunk 4; two Mamba layers and one full attention layer, dense FFNs."""
    return Counts.of({"port": {
        "d_model": 8, "vocab_size": 10, "num_heads": 2, "num_kv_heads": 2,
        "head_dim": 4, "d_ff": 16, "tie_embeddings": True,
        "layers": [{"pattern": [{"mixer": "mamba", "ffn": "dense"},
                                {"mixer": "full", "ffn": "dense"},
                                {"mixer": "mamba", "ffn": "dense"}],
                    "repeat": 1}],
        "ssm": {"d_state": 2, "d_conv": 4, "expand": 2, "head_dim": 4,
                "n_groups": 1, "chunk": 4}}})


def test_ssd_call_counts_by_hand():
    c = _mamba_counts()
    # L = 6: a whole chunk of 4 (10 causal pairs) and 2 (3 pairs)
    f, b = c.ssd_call(6)
    assert f == 13 * (2 * 1 * 2 + 2 * 4 * 4) + 6 * 4 * 4 * 2 * 4
    # x (bf16) 6·16, dt (f32) 6·4, B and C (bf16) 2·6·2, y (f32) 6·16,
    # the final state (f32) 4·4·2
    assert b == 2 * 96 + 4 * 24 + 2 * 24 + 4 * 96 + 4 * 32


def test_mamba_step_and_state_counts_by_hand():
    c = _mamba_counts()
    f, b = c.mamba_step(3)
    assert f == 3 * 5 * 4 * 4 * 2
    # a slot: the f32 state [4, 4, 2] read and written, 3 rows of the conv
    # history of x, B and C (16 + 2 + 2 channels, bf16) read
    assert b == 3 * (2 * 32 * 4 + 3 * 20 * 2)
    assert c.state_bytes_per_slot() == 2 * (32 * 4 + 3 * 20 * 2)
    assert c.mamba_layers() == 2 and c.flash_layers() == 1
    # weights: z, x, B, C, dt projections, the conv, out_proj
    assert c.mixer_params("mamba") == 8 * (2 * 16 + 2 * 2 + 4) \
        + 4 * (16 + 2 * 2) + 16 * 8
    assert c.kv_bytes_per_token() == 2 * 2 * 4 * 2      # one layer keeps KV
    assert c.pair_flops("mamba") == 0
    dense = 2 * c.layer_params(True) + 2 * 8 * 10
    assert c.decode_flops([5, 7]) == 2 * dense + 4 * 2 * 4 * 12 \
        + 2 * c.mamba_step(2)[0]
    assert c.prefill_flops(6) == 2 * c.layer_params(True) * 6 + 2 * 8 * 10 \
        + 4 * 2 * 4 * 21 + 2 * c.ssd_call(6)[0]


def _run(tracked, t_w=10.0, t_end=20.0, events=(), steps=()):
    loop = types.SimpleNamespace(tracked=tracked, events=list(events),
                                 steps=list(steps),
                                 waits=[(9.0, 2), (15.0, 0), (25.0, 1)])
    return RunRecord(cell=None, counts=Counts.of(MINICPM), loop=loop,
                     t_w=t_w, t_end=t_end, setup_s=3.0)


def _tr(due, slo, times, done=None):
    tr = Tracked(Request(0, 10, 5, slo), None, 0, due, due)
    tr.times = times
    tr.first_t = times[0][0] if times else None
    tr.done_t = done
    return tr


def _read(name, run):
    return spec.metric_reader(name).read(run)


def test_goodput_counts_deadlines_of_requests_due_in_the_window():
    trs = [_tr(11.0, 2.0, [(11.5, 2), (12.5, 3)], done=12.5),   # met
           _tr(12.0, 1.0, [(12.5, 2), (13.5, 3)], done=13.5),   # missed
           _tr(19.0, 5.0, [(19.5, 2), (23.0, 3)], done=23.0),   # met after
           _tr(9.0, 5.0, [(9.5, 2), (10.5, 3)], done=10.5),     # before
           _tr(15.0, 1.0, [(15.5, 2)])]                         # never done
    assert _read("goodput_rps", _run(trs)) == pytest.approx(2 / 10.0)


def test_ttft_censors_at_the_window_end():
    trs = [_tr(10.0 + i, 9.0, [(10.0 + i + 0.1 * (i + 1), 2)])
           for i in range(9)]
    trs.append(_tr(19.0, 9.0, []))          # no token by the end: age 1.0
    import numpy as np
    waits = [0.1 * (i + 1) for i in range(9)] + [1.0]
    assert _read("ttft_p90_s", _run(trs)) == pytest.approx(
        float(np.percentile(waits, 90)))


def test_tpot_counts_only_tokens_inside_the_window():
    tr = _tr(8.0, 9.0, [(9.0, 2), (10.0, 1), (10.5, 1), (11.0, 1),
                        (25.0, 1)])
    # inside: 3 tokens from 10.0 to 11.0 -> 0.5 s a token
    assert _read("tpot_p90_ms", _run([tr])) == pytest.approx(500.0)
    lone = _tr(8.0, 9.0, [(9.0, 2), (19.9, 1)])
    assert _read("tpot_p90_ms", _run([lone])) is None
    assert _read("output_tokens_per_s", _run([tr, lone])) == \
        pytest.approx(4 / 10.0)


def test_event_metrics():
    ev = [(0, "prefill", 1000, 0.05, 12.0), (1, "prefill", 500, 0.05, 13.0),
          (0, "decode", 16, 0.010, 14.0), (0, "decode", 16, 0.014, 15.0),
          (0, "decode", 16, 0.5, 21.0)]
    run = _run([], events=ev)
    assert _read("prefill_ms_per_ktok", run) == pytest.approx(0.1 / 1500 * 1e6)
    assert _read("decode_step_ms", run) == pytest.approx(12.0)
    assert _read("waiting_requests", run) == pytest.approx(1.0)
    assert _read("flash_attention_roofline", run) is None   # no trace
