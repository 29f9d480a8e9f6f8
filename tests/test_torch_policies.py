"""The port's copies of the rest of GoodServe's control plane against the
JAX package's: pool controllers and admission (``core/controller.py``),
the fairness policy (``core/fairness.py``), sharded gateways over stale
views (``core/sharded_plane.py``), decision traces, what-if replay and
off-policy estimates (``core/replay.py``) and the LinUCB bandit router
(``core/learned_router.py``).  The same seeded traces go through both
packages and every compared value must be exactly equal (``==``, no
tolerance).  Wall-clock fields (decision latencies) are never compared.
Plus the port's own ``launch.goodput.policy_runs`` on the CPU."""
import dataclasses
import json
import types

import numpy as np
import pytest
from conftest import ConstPredictor

torch = pytest.importorskip("torch")

from repro.cluster import hardware as JHW  # noqa: E402
from repro.cluster import simulator as JS  # noqa: E402
from repro.cluster import workload as JW  # noqa: E402
from repro.core import control_plane as JC  # noqa: E402
from repro.core import controller as JCT  # noqa: E402
from repro.core import fairness as JF  # noqa: E402
from repro.core import learned_router as JLR  # noqa: E402
from repro.core import metrics as JM  # noqa: E402
from repro.core import replay as JRP  # noqa: E402
from repro.core import router as JR  # noqa: E402
from repro.core import sharded_plane as JSP  # noqa: E402
from repro_torch.cluster import hardware as THW  # noqa: E402
from repro_torch.cluster import simulator as TS  # noqa: E402
from repro_torch.cluster import workload as TW  # noqa: E402
from repro_torch.core import control_plane as TC  # noqa: E402
from repro_torch.core import controller as TCT  # noqa: E402
from repro_torch.core import fairness as TF  # noqa: E402
from repro_torch.core import learned_router as TLR  # noqa: E402
from repro_torch.core import metrics as TM  # noqa: E402
from repro_torch.core import replay as TRP  # noqa: E402
from repro_torch.core import router as TR  # noqa: E402
from repro_torch.core import sharded_plane as TSP  # noqa: E402

JAX = types.SimpleNamespace(hw=JHW, sim=JS, wl=JW, cp=JC, ctl=JCT, fair=JF,
                            lr=JLR, met=JM, rep=JRP, rt=JR, shp=JSP)
PORT = types.SimpleNamespace(hw=THW, sim=TS, wl=TW, cp=TC, ctl=TCT, fair=TF,
                             lr=TLR, met=TM, rep=TRP, rt=TR, shp=TSP)
MODEL = "llama3.1-8b"


def _pool(pkg, names, max_seqs=None, profiles=None):
    fp = pkg.hw.footprint(MODEL)
    hws = [pkg.hw.GPUS[n] if max_seqs is None
           else dataclasses.replace(pkg.hw.GPUS[n], max_seqs=max_seqs)
           for n in names]
    return pkg.sim.Cluster([pkg.sim.Instance(i, hw, fp)
                            for i, hw in enumerate(hws)], profiles=profiles)


def _stream(out):
    """The decision stream: every request's instance, finish and journey."""
    return [(r.req.rid, r.instance, r.finished_at, r.state, r.journey)
            for r in out]


def _both(run):
    """``run(pkg)`` on the JAX package, then on the port."""
    return run(JAX), run(PORT)


def _same(a, b) -> bool:
    """Exact equality in which NaN equals NaN (``pred_mae_tokens`` of a
    run that predicts nothing): floats are compared by their repr."""
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


# ---------------------------------------------------------------------------
# core/controller.py: pool controllers and admission
# ---------------------------------------------------------------------------

def _elastic(pkg, kind):
    """fig13's elastic cell, cut to 500 requests over one diurnal swell:
    base pool H800 + A800 (32 slots), the controller buying A800/A40."""
    reqs = pkg.wl.make_workload(n=500, rps=11.0, slo_scale=2.5, seed=4,
                                arrival="diurnal",
                                arrival_kw=dict(period=60.0, amplitude=0.85))
    cluster = _pool(pkg, ("H800", "A800"), max_seqs=32)
    types_ = tuple(dataclasses.replace(pkg.hw.GPUS[n], max_seqs=32)
                   for n in ("A800", "A40"))
    ctl = (pkg.ctl.ReactivePoolController if kind == "reactive"
           else pkg.ctl.ForecastPoolController)(
        scale_types=types_, max_instances=4, min_active=2, interval=4.0,
        hi_load=12.0, lo_pending=2.5, cooldown=1, warmup_override=20.0)
    pred = ConstPredictor(150.0)
    plane = pkg.cp.ControlPlane(
        router=pkg.rt.make_router("goodserve", predictor=pred), pool=ctl,
        admission=pkg.ctl.AdmissionController(pred, margin=3.0))
    out, dur = pkg.sim.Simulator(cluster, plane, reqs).run()
    return (pkg.met.summarize_elastic(out, dur, cluster), list(ctl.events),
            _stream(out))


@pytest.mark.parametrize("kind", ["reactive", "forecast"])
def test_pool_controllers_equal_jax(kind):
    want, got = _both(lambda pkg: _elastic(pkg, kind))
    assert got == want
    summary, events, _ = got
    actions = [a for _, a, _ in events]
    assert "provision" in actions and summary["n_instances_total"] > 2
    assert summary["n"] == 500


def _default_reactive(pkg):
    """``ReactivePoolController()`` as constructed by default (catalog
    names A800 and A40) on a one-H800 pool under a burst."""
    reqs = pkg.wl.make_workload(n=200, rps=20.0, slo_scale=3.0, seed=6)
    cluster = _pool(pkg, ("H800",), max_seqs=16)
    ctl = pkg.ctl.ReactivePoolController(warmup_override=10.0)
    plane = pkg.cp.ControlPlane(router=pkg.rt.make_router("least_request"),
                                pool=ctl)
    out, dur = pkg.sim.Simulator(cluster, plane, reqs).run()
    return (pkg.met.summarize_elastic(out, dur, cluster), list(ctl.events),
            _stream(out))


def test_default_reactive_controller_equal_jax():
    want, got = _both(_default_reactive)
    assert _same(got, want) and got[1]


def _admission(pkg, margin):
    reqs = pkg.wl.make_workload(n=300, rps=12.0, slo_scale=1.0, seed=3)
    pred = ConstPredictor(150.0)
    adm = pkg.ctl.AdmissionController(pred, margin=margin)
    plane = pkg.cp.ControlPlane(
        router=pkg.rt.make_router("goodserve", predictor=pred),
        admission=adm)
    cluster = pkg.sim.build_paper_cluster()
    out, dur = pkg.sim.Simulator(cluster, plane, reqs, tau=50).run()
    return pkg.met.summarize_elastic(out, dur, cluster), _stream(out)


@pytest.mark.parametrize("margin", [0.5, 3.0])
def test_admission_equal_jax(margin):
    want, got = _both(lambda pkg: _admission(pkg, margin))
    assert got == want and got[0]["n_shed"] > 0


# ---------------------------------------------------------------------------
# core/fairness.py
# ---------------------------------------------------------------------------

def _fair(pkg, preempt):
    """fig18's fair plane, cut to 700 requests: 12 Zipf tenants, tenant 0
    an abuser with half the traffic as best effort."""
    spec = pkg.wl.TenantSpec(n_tenants=12, zipf_a=1.1, abuser=0,
                             abuser_share=0.5, abuser_class="best_effort")
    reqs = pkg.wl.make_workload(n=700, rps=48.0, slo_scale=2.5, seed=5,
                                arrival="mooncake")
    pkg.wl.assign_tenants(reqs, spec, seed=6)
    cluster = _pool(pkg, ("H800", "A800", "A800", "A800"))
    beliefs = pkg.cp.Beliefs(predictor=ConstPredictor(150.0))
    fair = pkg.fair.FairnessPolicy(
        quantum_tps=40000.0, burst_s=2.0, overload_pending=4.0,
        class_shed={"best_effort": 16.0, "standard": 32.0},
        preempt=preempt, park_timeout_s=15.0, release_pending=4.0)
    plane = pkg.cp.ControlPlane(
        router=pkg.rt.make_router("goodserve", predictor=beliefs.predictor),
        admission=pkg.ctl.AdmissionController(beliefs=beliefs, margin=3.0),
        beliefs=beliefs, fairness=fair)
    out, dur = pkg.sim.Simulator(cluster, plane, reqs).run()
    return {"summary": pkg.met.summarize_elastic(out, dur, cluster),
            "tenants": pkg.met.per_tenant_breakdown(out, dur),
            "classes": pkg.met.per_class_breakdown(out, dur),
            "ledger": fair.ledger(), "stream": _stream(out)}


@pytest.mark.parametrize("preempt", [False, True])
def test_fairness_equal_jax(preempt):
    want, got = _both(lambda pkg: _fair(pkg, preempt))
    assert got == want
    led = got["ledger"]
    assert led["throttle_log"] or led["shed_log"]
    if preempt:
        assert led["preempt_log"] and led["release_log"]


# ---------------------------------------------------------------------------
# core/sharded_plane.py
# ---------------------------------------------------------------------------

def _replica(pkg):
    def build(_i):
        beliefs = pkg.cp.Beliefs(predictor=ConstPredictor(150.0))
        return pkg.cp.ControlPlane(
            router=pkg.rt.make_router("goodserve", beliefs=beliefs),
            beliefs=beliefs)
    return build


def _sharded(pkg, n, interval):
    """fig16's tight testbed (8 slots per engine) at its knee, 3 req/s."""
    reqs = pkg.wl.make_workload(n=300, rps=3.0, slo_scale=3.0, seed=5)
    cluster = _pool(pkg, ("H800", "A800", "A40", "V100"), max_seqs=8)
    plane = pkg.shp.make_sharded_plane(n, _replica(pkg),
                                       sync_interval_s=interval)
    out, dur = pkg.sim.Simulator(cluster, plane, reqs).run()
    return {"summary": pkg.met.summarize(out, dur),
            "conflicts": list(plane.conflict_log),
            "syncs": [(s.sync_log, s.max_staleness) for s in plane.shards],
            "stream": _stream(out)}


@pytest.mark.parametrize("n,interval", [(1, 0.0), (4, 1.0), (4, 0.25),
                                        (2, 4.0)])
def test_sharded_plane_equal_jax(n, interval):
    want, got = _both(lambda pkg: _sharded(pkg, n, interval))
    assert got == want
    assert got["summary"]["n"] == 300


def test_single_fresh_replica_replays_the_unsharded_plane():
    """N=1 with ``sync_interval_s <= 0`` is byte-identical to one plane."""
    sharded = _sharded(PORT, 1, 0.0)
    reqs = TW.make_workload(n=300, rps=3.0, slo_scale=3.0, seed=5)
    cluster = _pool(PORT, ("H800", "A800", "A40", "V100"), max_seqs=8)
    out, dur = TS.Simulator(cluster, _replica(PORT)(0), reqs).run()
    assert sharded["stream"] == _stream(out)
    assert sharded["summary"] == TM.summarize(out, dur)
    assert sharded["conflicts"] == []


def test_sharded_plane_conflicts_equal_jax():
    """Four replicas on one slot with stale views race for it: the losing
    routes are rejected and retried identically in both packages."""
    def race(pkg):
        reqs = pkg.wl.make_workload(n=60, rps=8.0, slo_scale=4.0, seed=2)
        cluster = _pool(pkg, ("A800",), max_seqs=1)
        plane = pkg.shp.make_sharded_plane(
            4, lambda i: pkg.cp.ControlPlane(
                router=pkg.rt.make_router("least_request")),
            sync_interval_s=2.0)
        out, dur = pkg.sim.Simulator(cluster, plane, reqs).run()
        return list(plane.conflict_log), _stream(out)
    want, got = _both(race)
    assert got == want and got[0]


# ---------------------------------------------------------------------------
# core/replay.py: traces, what-if replay, off-policy estimates
# ---------------------------------------------------------------------------

def _recorded(pkg, router, seed=3, n=120):
    reqs = pkg.wl.make_workload(n=n, rps=6.0, slo_scale=(1.4, 2.6),
                                seed=seed)
    plane = pkg.cp.ControlPlane(router=router, record=True)
    out, dur = pkg.sim.Simulator(pkg.sim.build_paper_cluster(), plane,
                                 reqs, tau=50).run()
    return plane.trace, out


def _goodserve(pkg):
    return pkg.rt.make_router("goodserve", predictor=ConstPredictor(150.0))


def test_trace_json_equal_jax_and_loads_across_packages(tmp_path):
    (jt, _), (tt, _) = _both(lambda pkg: _recorded(pkg, _goodserve(pkg)))
    assert tt.to_json() == jt.to_json()
    assert json.loads(tt.to_json())["schema_version"] == \
        TRP.SCHEMA_VERSION == JRP.SCHEMA_VERSION
    tt.save(tmp_path / "port.json")
    jt.save(tmp_path / "jax.json")
    assert JRP.DecisionTrace.load(tmp_path / "port.json").to_json() == \
        jt.to_json()
    back = TRP.DecisionTrace.load(tmp_path / "jax.json")
    assert back.to_json() == tt.to_json()
    # the JSON floats round-trip: the loaded trace rebuilds the requests
    assert [dataclasses.asdict(r) for r in back.requests_objects()] == \
        [dataclasses.asdict(r) for r in tt.requests_objects()]


def test_replay_whatif_and_dr_estimate_equal_jax():
    def run(pkg):
        trace, _ = _recorded(pkg, pkg.lr.BanditRouter(
            predictor=ConstPredictor(150.0), eps=0.3, seed=1), n=110)
        same = pkg.rep.replay_whatif(
            trace, lambda c: pkg.cp.ControlPlane(router=pkg.rt.make_router(
                "least_request")), pkg.sim.build_paper_cluster)
        est = pkg.rep.dr_estimate(
            trace, pkg.rep.JustEnoughOfflinePolicy(margin=0.7))
        return {"value": pkg.rep.realized_value(same, trace),
                "regret": pkg.rep.shed_regret(trace, same),
                "stream": _stream(same.requests), "dr": est}
    want, got = _both(run)
    assert got == want
    assert 0.0 <= got["value"] <= 1.0 and got["dr"]["n"] > 0


class _Trace:
    """Stands in for a ``DecisionTrace``: ``dr_estimate`` reads only its
    routed events."""

    def __init__(self, events):
        self.events = events

    def route_events(self):
        return self.events


class _Picks:
    """An offline policy that picks a fixed instance per request."""

    def __init__(self, picks):
        self.picks = picks

    def offline_choose(self, event):
        return self.picks[event["rid"]]


def _event(rid, cands, gid, propensity, reward):
    return {"rid": rid, "gid": gid, "propensity": propensity,
            "outcome": {"reward": reward},
            "candidates": [{"iid": i, "hw": hw, "bucket": b}
                           for i, (hw, b) in enumerate(cands)]}


def _synthetic(seed: int, n: int = 60):
    """A seeded trace of ``n`` routed events (1-3 candidates on two
    hardware kinds and three load buckets, propensities in [0.02, 1],
    rewards 0 or 1) and a seeded policy over it."""
    rng = np.random.default_rng(seed)
    events, picks = [], {}
    for rid in range(n):
        k = int(rng.integers(1, 4))
        cands = [(str(rng.choice(["H100", "A40"])), int(rng.integers(0, 3)))
                 for _ in range(k)]
        events.append(_event(rid, cands, int(rng.integers(0, k)),
                             float(rng.uniform(0.02, 1.0)),
                             float(rng.integers(0, 2))))
        picks[rid] = int(rng.integers(0, k))
    return _Trace(events), _Picks(picks)


def _dr_bounds(est, max_weight):
    """What the estimator guarantees: the direct value and the match rate
    in [0, 1] (rewards are 0 or 1), and each matched event's residual
    ``w (reward - Q)`` at most ``max_weight`` in size."""
    return (0.0 <= est["direct"] <= 1.0 and 0.0 <= est["match_rate"] <= 1.0
            and np.isfinite(est["value"])
            and abs(est["value"] - est["direct"])
            <= max_weight * est["match_rate"])


@pytest.mark.parametrize("max_weight", [20.0, 5.0])
def test_dr_estimate_keeps_its_bounds_and_may_leave_zero_one(max_weight):
    """On seeded synthetic traces the doubly-robust value lies within
    ``max_weight * match_rate`` of the direct value, as the reference's
    does (equal), and not always in [0, 1]: one matched reward of 1 at
    propensity 0.05 among nine of 0 (Q = 0.1) lifts it to 0.1 + (min(20,
    max_weight) * 0.9 - 0.9) / 10: 1.81 at the default weight cap."""
    for seed in range(20):
        trace, policy = _synthetic(seed)
        est = TRP.dr_estimate(trace, policy, max_weight=max_weight)
        assert est == JRP.dr_estimate(trace, policy, max_weight=max_weight)
        assert _dr_bounds(est, max_weight) and est["n"] == 60
    events = [_event(rid, [("H100", 0)], 0, 1.0 if rid else 0.05,
                     0.0 if rid else 1.0) for rid in range(10)]
    est = TRP.dr_estimate(_Trace(events), _Picks({i: 0 for i in range(10)}),
                          max_weight=max_weight)
    assert est == JRP.dr_estimate(_Trace(events),
                                  _Picks({i: 0 for i in range(10)}),
                                  max_weight=max_weight)
    assert est["match_rate"] == 1.0
    assert est["direct"] == pytest.approx(0.1)
    assert est["value"] == pytest.approx(0.1 + (min(20.0, max_weight) * 0.9
                                                - 0.9) / 10)
    assert _dr_bounds(est, max_weight)
    assert (est["value"] > 1.0) == (max_weight == 20.0)     # 1.81, 0.46


def test_port_trace_replays_in_jax_and_back():
    """A trace recorded by the port, loaded by the reference, replays to
    the same what-if result in both packages."""
    tt, _ = _recorded(PORT, _goodserve(PORT))
    jt = JRP.DecisionTrace.from_json(tt.to_json())
    j = JRP.replay_whatif(jt, lambda c: JC.ControlPlane(
        router=_goodserve(JAX)), JS.build_paper_cluster)
    t = TRP.replay_whatif(tt, lambda c: TC.ControlPlane(
        router=_goodserve(PORT)), TS.build_paper_cluster)
    assert _stream(t.requests) == _stream(j.requests)
    assert TRP.realized_value(t, tt) == JRP.realized_value(j, jt)


# ---------------------------------------------------------------------------
# core/learned_router.py: the bandit
# ---------------------------------------------------------------------------

def _bandit_run(pkg):
    router = pkg.lr.BanditRouter(predictor=ConstPredictor(150.0), eps=0.3,
                                 seed=4)
    trace, out = _recorded(pkg, router, seed=7, n=150)
    warm = pkg.lr.BanditRouter(predictor=ConstPredictor(150.0), eps=0.05,
                               seed=9)
    n_updates = warm.warm_start(trace)
    return {"stream": _stream(out), "state": router.state(),
            "decisions": [(e["rid"], e.get("gid"), e.get("propensity"))
                          for e in trace.route_events()],
            "warm": (n_updates, warm.state()),
            "dr": pkg.rep.dr_estimate(trace, warm)}


def test_bandit_decisions_state_and_warm_start_equal_jax():
    want, got = _both(_bandit_run)
    assert got == want
    assert got["warm"][0] > 0 and got["state"]["arms"]
    # some decisions explored: the logged propensities are not all 1
    assert any(p is not None and p < 1.0 for _, _, p in got["decisions"])


def test_bandit_state_loads_across_packages():
    st = _bandit_run(PORT)["state"]
    j = JLR.BanditRouter(predictor=ConstPredictor(150.0))
    j.load_state(json.loads(json.dumps(st)))
    t = TLR.BanditRouter(predictor=ConstPredictor(150.0))
    t.load_state(json.loads(json.dumps(st)))
    assert t.state() == j.state() == st


def test_make_router_bandit_is_the_ports_bandit():
    r = TR.make_router("bandit", predictor=ConstPredictor(150.0), eps=0.2,
                       seed=3)
    assert isinstance(r, TLR.BanditRouter) and r.eps == 0.2
    assert type(r).__module__ == "repro_torch.core.learned_router"


# ---------------------------------------------------------------------------
# launch/goodput.py: the policies over the pool with a profiled H100
# ---------------------------------------------------------------------------

def test_policy_runs_account_for_every_request():
    from repro_torch.bench.profile import analytic_profile
    from repro_torch.core.predictor import HistoryPredictor
    from repro_torch.launch import goodput
    pred = HistoryPredictor().fit(TW.train_corpus(n=300, seed=1))
    prof = analytic_profile(THW.GPUS["H100"], THW.footprint(MODEL))
    rows = goodput.policy_runs(pred, prof, n=120)
    assert [r["policy"] for r in rows] == goodput.POLICIES
    for r in rows:
        acc = r["accounting"]
        assert acc["open"] == 0 and sum(acc.values()) == r["n"] == 120
        assert acc["finished"] == r["n_finished"]
    by = {r["policy"]: r for r in rows}
    assert by["sharded"]["replicas"] == 4
    assert 0.0 <= by["sharded"]["max_staleness_s"] <= 1.0
    assert 0.0 <= by["bandit"]["dr_value"] <= 1.0
    assert 0.0 <= by["bandit"]["whatif_value"] <= 1.0
    b = by["bandit"]
    assert _dr_bounds({"value": b["dr_value"], "direct": b["dr_direct"],
                       "match_rate": b["dr_match_rate"]}, 20.0)
    assert by["bandit"]["warm_start_events"] > 0
