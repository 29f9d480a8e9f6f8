"""The frozen copy of the paper's generator against numbers recorded
here, and the general generator's promises: one seed gives one set of
inputs; every seed sends the same sizes and arrivals, in another order."""
import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

import portbench_testkit as K  # noqa: E402
from pb import spec, workload as W  # noqa: E402
from pb.counts import Counts  # noqa: E402
from pb.traffic import Traffic  # noqa: E402


def test_families_draw_the_recorded_stream():
    rng = np.random.default_rng(0)
    got = [(d.family, d.input_len, d.output_len)
           for d in (W.sample_request(rng) for _ in range(6))]
    assert got == [("swe", 866, 184), ("swe", 1150, 146), ("swe", 840, 271),
                   ("code", 388, 308), ("code", 405, 307), ("code", 345, 259)]


def test_family_statistics_over_2000_draws():
    rng = np.random.default_rng(0)
    d = [W.sample_request(rng) for _ in range(2000)]
    inp = np.array([x.input_len for x in d])
    out = np.array([x.output_len for x in d])
    assert inp.mean() == pytest.approx(548.2535)
    assert inp.max() == 1582 and out.max() == 1259
    assert out.mean() == pytest.approx(212.1065)
    assert inp.max() + out.max() < 4095


def test_mooncake_arrivals_recorded():
    a = W.mooncake_like_arrivals(np.random.default_rng(1), 6, 2.0, cv=1.3,
                                 burst_period=20.0, swing=0.35)
    assert a.tolist() == pytest.approx(
        [0.27329068196566747, 0.4612396611127803, 0.6352363206006946,
         0.637057417978494, 0.9193981807721567, 1.6485084777823589])


def test_solo_latency_on_the_analytic_a800():
    conf = spec.load_cell(K.ROOT, "minicpm-2b.agentic").config
    c = Counts.of(conf)
    fp = W.Footprint(c.all_params(), c.all_params(), c.kv_bytes_per_token())
    assert c.kv_bytes_per_token() == 368640
    assert W.solo_latency(W.A800, fp, 551, 215) == pytest.approx(
        1.7428160122880638)


def _traffic(name, seed):
    cell = spec.load_cell(K.ROOT, name)
    return Traffic(cell.traffic, cell.settings, cell.config, seed,
                   cell.run_seconds, cell.config["serving"]["max_len"])


@pytest.mark.parametrize("name", K.CELLS)
def test_one_seed_one_input_and_every_seed_the_same_sizes(name):
    a, b, c = _traffic(name, 7), _traffic(name, 7), _traffic(name, 2 ** 31 + 9)
    sizes = lambda t: [(r.input_len, r.output_len, r.slo) for r in t.requests]
    assert sizes(a) == sizes(b)
    assert a.tokens(a.requests[3]) == b.tokens(b.requests[3])
    assert a.tokens(a.requests[3]) != c.tokens(c.requests[3])
    assert sorted(sizes(a)) == sorted(sizes(c)) and sizes(a) != sizes(c)
    if a.open:
        assert [r.due for r in a.requests] == [r.due for r in c.requests]
    for t in (a, c):
        for r in t.requests:
            assert 2 <= r.output_len and r.input_len + r.output_len < 4095


def test_long_session_first_round_spreads_its_outputs():
    t = _traffic("minicpm-2b.long_session", 11)
    first = t.requests[:t.clients]
    later = t.requests[t.clients:]
    assert all(1536 <= r.input_len <= 2560 for r in t.requests)
    assert min(r.output_len for r in first) < 200
    assert all(768 <= r.output_len <= 1280 for r in later)
