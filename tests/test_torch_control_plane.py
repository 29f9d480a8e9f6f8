"""The port's copies of GoodServe's control plane, simulator, workloads,
metrics and latency profiles against the JAX package's: on the same
seeded traces their outputs must be exactly equal (``summarize`` dicts
compared with ``==``, no tolerance).  Plus the port's own additions: the
``measured-cuda`` provenance, the H100 catalog entry, the profile the port
measures on its engine (which the reference must load), and the goodput
launcher's pools."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.bench import harness as JH  # noqa: E402
from repro.bench import profile as JP  # noqa: E402
from repro.cluster import hardware as JHW  # noqa: E402
from repro.cluster import simulator as JS  # noqa: E402
from repro.cluster import workload as JW  # noqa: E402
from repro.core import control_plane as JC  # noqa: E402
from repro.core import metrics as JM  # noqa: E402
from repro.core import predictor as JPR  # noqa: E402
from repro.core import router as JR  # noqa: E402
from repro_torch.bench import harness as TH  # noqa: E402
from repro_torch.bench import profile as TP  # noqa: E402
from repro_torch.cluster import hardware as THW  # noqa: E402
from repro_torch.cluster import simulator as TS  # noqa: E402
from repro_torch.cluster import workload as TW  # noqa: E402
from repro_torch.core import control_plane as TC  # noqa: E402
from repro_torch.core import metrics as TM  # noqa: E402
from repro_torch.core import predictor as TPR  # noqa: E402
from repro_torch.core import router as TR  # noqa: E402

ROUTERS = ["random", "round_robin", "least_request", "lowest_tpm",
           "prefix_cache", "preble", "llumnix", "goodserve"]
MODELS = ["llama3.1-8b", "qwen2.5-14b"]
SHARED_GPUS = sorted(set(JHW.GPUS) & set(THW.GPUS))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def history():
    """Each package's ``HistoryPredictor``, fitted on the same corpus."""
    return (JPR.HistoryPredictor().fit(JW.train_corpus(n=300, seed=1)),
            TPR.HistoryPredictor().fit(TW.train_corpus(n=300, seed=1)))


def _asdicts(reqs):
    return [dataclasses.asdict(r) for r in reqs]


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("slo", [2.0, (1.0, 3.0)])
def test_workloads_equal_jax(model, slo):
    kw = dict(n=150, rps=10.0, slo_scale=slo, model=model, seed=3)
    assert _asdicts(TW.make_workload(**kw)) == _asdicts(JW.make_workload(**kw))


def test_corpus_and_workflow_traces_equal_jax():
    assert _asdicts(TW.train_corpus(n=200, seed=1)) == \
        _asdicts(JW.train_corpus(n=200, seed=1))
    treqs, twf = TW.make_workflow_workload(n_workflows=12, seed=2)
    jreqs, jwf = JW.make_workflow_workload(n_workflows=12, seed=2)
    assert _asdicts(treqs) == _asdicts(jreqs)
    assert [dataclasses.asdict(w) for w in twf] == \
        [dataclasses.asdict(w) for w in jwf]


@pytest.mark.parametrize("model", MODELS + ["mamba2-1.3b"])
def test_footprints_equal_jax(model):
    assert dataclasses.asdict(THW.footprint(model)) == \
        dataclasses.asdict(JHW.footprint(model))


def test_h100_entry_is_the_h800_silicon():
    h100, h800 = THW.GPUS["H100"], THW.GPUS["H800"]
    assert dataclasses.replace(h100, name="H800") == h800
    assert (h100.tflops, h100.hbm_gbps, h100.mem_gb) == (989.0, 3350.0, 80.0)
    assert THW.catalog("H100-spot").is_spot
    assert {k: v for k, v in THW.GPUS.items() if k != "H100"} == {
        k: THW.HardwareSpec(**dataclasses.asdict(v))
        for k, v in JHW.GPUS.items()}
    assert THW.PAPER_CLUSTER == JHW.PAPER_CLUSTER


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("gpu", SHARED_GPUS)
def test_analytic_profile_json_equal_jax(gpu, model):
    t = TP.analytic_profile(THW.GPUS[gpu], THW.footprint(model))
    j = JP.analytic_profile(JHW.GPUS[gpu], JHW.footprint(model))
    assert t.to_json() == j.to_json()
    assert json.dumps(t.to_json(), sort_keys=True) == \
        json.dumps(j.to_json(), sort_keys=True)
    for b, c in ((3, 700.0), (64, 9000.0)):
        assert t.decode_time(b, c) == j.decode_time(b, c)
    assert t.prefill_time(3000, 100) == j.prefill_time(3000, 100)
    assert dataclasses.astuple(t.priors()) == dataclasses.astuple(j.priors())


@pytest.fixture(scope="module")
def cpu_profile():
    from repro_torch.configs import get_config, reduce_config
    cfg = reduce_config(get_config("llama3.1-8b"))
    return TP.measure_engine_profile(cfg, THW.GPUS["H100"], device="cpu",
                                     meta={"note": "plumbing"})


def test_port_measured_profile_loads_in_jax(cpu_profile, tmp_path):
    prof = cpu_profile
    assert prof.provenance == "measured-cpu" and prof.hardware == "H100"
    assert prof.meta["warmup"]["passes"] == 1 and prof.meta["note"]
    flat = [t for row in prof.decode_s for t in row] + list(prof.prefill_s)
    assert all(np.isfinite(t) and t > 0 for t in flat)
    path = tmp_path / "prof.json"
    prof.save(path)
    j = JP.LatencyProfile.load(path)
    assert j.to_json() == prof.to_json()
    assert TP.LatencyProfile.from_json(j.to_json()) == prof
    for b, c in ((1, 16.0), (2, 24.0), (5, 300.0)):
        assert j.decode_time(b, c) == prof.decode_time(b, c)
    assert j.prefill_time(20) == prof.prefill_time(20)


def test_measured_cuda_is_the_ports_provenance(cpu_profile):
    d = dict(cpu_profile.to_json(), provenance="measured-cuda")
    assert TP.LatencyProfile.from_json(d).provenance == "measured-cuda"
    with pytest.raises(ValueError, match="provenance"):
        JP.LatencyProfile.from_json(d)      # the reference predates it


def test_measured_profile_records_each_entrys_spread(cpu_profile):
    """Every decode entry rests on ``decode_iters`` full-batch steps and
    every prefill entry on ``PREFILL_REPEATS`` prompts; each lies within
    its samples' range, and no point fell back to the roofline."""
    m = cpu_profile.meta
    assert m["analytic_points"] == []
    for row, spreads in zip(cpu_profile.decode_s, m["decode_spread_s"]):
        for t, sp in zip(row, spreads):
            assert sp["n"] == m["decode_iters"]
            assert sp["min"] <= sp["p25"] <= sp["p75"] <= sp["max"]
            assert sp["min"] <= t <= sp["max"]
    for t, sp in zip(cpu_profile.prefill_s, m["prefill_spread_s"]):
        assert sp["n"] == TP.PREFILL_REPEATS and sp["min"] <= t <= sp["max"]


def test_measured_profile_flags_analytic_points(monkeypatch):
    """A grid point with no full-batch decode step holds the analytic
    roofline, as in the reference, and is listed in
    ``meta["analytic_points"]`` (here forced by hiding the decode steps of
    the batch-2 engine)."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.engine.engine import InferenceEngine
    drain = InferenceEngine.drain_events

    def no_batch2_decode(self):
        return [e for e in drain(self)
                if not (e[0] == "decode" and self.max_batch == 2)]
    monkeypatch.setattr(InferenceEngine, "drain_events", no_batch2_decode)
    cfg = reduce_config(get_config("llama3.1-8b"))
    hw = THW.GPUS["H100"]
    prof = TP.measure_engine_profile(cfg, hw, batches=(1, 2), ctxs=(16,),
                                     chunks=(8,), device="cpu")
    assert prof.meta["analytic_points"] == [[2, 16]]
    assert prof.meta["decode_spread_s"][1] == [{"n": 0}]
    fp = THW.ModelFootprint.from_config(cfg)
    assert prof.decode_s[1][0] == THW.decode_iteration_time(hw, fp, 2, 16)
    assert prof.meta["decode_spread_s"][0][0]["n"] == 4


def test_goodput_loads_only_a_profile_of_its_slot(cpu_profile, tmp_path):
    """``--profile`` must name the H100 entry and the size's model."""
    from repro_torch.launch import goodput
    path = tmp_path / "prof.json"
    cpu_profile.save(path)
    assert goodput.load_profile(path, "reduced") == cpu_profile
    with pytest.raises(ValueError, match="llama3.1-8b-reduced"):
        goodput.load_profile(path, "full")
    dataclasses.replace(cpu_profile, hardware="A40").save(path)
    with pytest.raises(ValueError, match="A40"):
        goodput.load_profile(path, "reduced")


def _summaries(name, slo, history, n=120, profiles=None, seed=3):
    out = []
    for sim_mod, wl, rt, met, pred in (
            (JS, JW, JR, JM, history[0]), (TS, TW, TR, TM, history[1])):
        reqs = wl.make_workload(n=n, rps=10.0, slo_scale=slo, seed=seed)
        cluster = sim_mod.build_paper_cluster()
        if profiles is not None:
            cluster = sim_mod.Cluster(cluster.instances,
                                      profiles=profiles(sim_mod))
        router = rt.make_router(name, predictor=pred
                                if name == "goodserve" else None)
        sim = sim_mod.Simulator(cluster, router, reqs, tau=50)
        res, dur = sim.run()
        out.append((met.summarize(res, dur), router, res))
    return out


@pytest.mark.parametrize("slo", [1.0, 2.0])
@pytest.mark.parametrize("name", ROUTERS)
def test_router_summaries_equal_jax(name, slo, history):
    (js, jr, jres), (ts, tr, tres) = _summaries(name, slo, history)
    assert ts == js
    assert ts["n_finished"] == 120
    # the decision stream: every request's route, migrations and finish
    assert [(r.req.rid, r.instance, r.finished_at, r.journey)
            for r in tres] == [(r.req.rid, r.instance, r.finished_at,
                                r.journey) for r in jres]


def test_summaries_equal_jax_with_a_profile(history):
    def profiles(sim_mod):
        hw = (JHW if sim_mod is JS else THW)
        prof = (JP if sim_mod is JS else TP).analytic_profile(
            hw.GPUS["H800"], hw.footprint("llama3.1-8b"),
            batches=(1, 4, 16), ctxs=(256.0, 2048.0), chunks=(128, 1024))
        return {"H800": prof}
    (js, _, _), (ts, _, _) = _summaries("goodserve", 2.0, history,
                                        profiles=profiles)
    (plain, _, _), _ = _summaries("goodserve", 2.0, history)
    assert ts == js and ts != plain      # the profile changed the run


def test_run_experiment_equal_jax(history):
    def spec(sim_mod, wl, cp, rt, harness, pred):
        return harness.ExperimentSpec(
            name="parity", pool=sim_mod.build_paper_cluster,
            workload=lambda seed: wl.make_workload(n=100, seed=seed),
            plane=lambda cluster: cp.ControlPlane(
                router=rt.make_router("goodserve", predictor=pred)),
            seeds=(0, 1))
    j = JH.run_experiment(spec(JS, JW, JC, JR, JH, history[0]))
    t = TH.run_experiment(spec(TS, TW, TC, TR, TH, history[1]))
    assert [r.summary for r in t] == [r.summary for r in j]
    assert TH.aggregate_results(t) == JH.aggregate_results(j)


def test_unported_modules_raise():
    with pytest.raises(NotImplementedError, match="A11"):
        TR.make_router("bandit")
    with pytest.raises(NotImplementedError, match="A11"):
        TC.ControlPlane(TR.make_router("random"), record=True)


def test_goodput_pools_run_the_profile(cpu_profile, history):
    """The launcher's H100 pool puts the profile on its H100 and nothing
    else; every request of each run finishes."""
    from repro_torch.launch import goodput
    pool = goodput.build_pool("h100", cpu_profile)
    assert [g.hw.name for g in pool.instances] == ["H100", "A800", "A40",
                                                   "V100"]
    assert pool.instances[0].profile is cpu_profile
    assert all(g.profile is None for g in pool.instances[1:])
    assert all(g.profile is None
               for g in goodput.build_pool("paper", cpu_profile).instances)
    rows = goodput.run_goodput(history[1], cpu_profile, n=60, scales=(2.0,),
                               routers=["least_request", "goodserve"])
    runs = [r for r in rows if "router" in r]
    assert [(r["pool"], r["router"]) for r in runs] == [
        ("paper", "least_request"), ("paper", "goodserve"),
        ("h100", "least_request"), ("h100", "goodserve")]
    assert all(r["n_finished"] == 60 for r in runs)
    margins = [r for r in rows if "margin" in r]
    assert len(margins) == 2 and all(np.isfinite(r["margin"])
                                     for r in margins)
    paper = [r for r in runs if r["pool"] == "paper"]
    (_, _, _), (want, _, _) = _summaries("least_request", 2.0, history, n=60)
    assert {k: paper[0][k] for k in want} == want


def test_analytic_beside_is_the_h800_at_the_grid(cpu_profile):
    from repro_torch.launch import goodput
    a = goodput.analytic_beside(cpu_profile)
    assert a.hardware == "H800" and a.provenance == "analytic"
    assert (a.decode_batches, a.decode_ctxs, a.prefill_tokens) == (
        cpu_profile.decode_batches, cpu_profile.decode_ctxs,
        cpu_profile.prefill_tokens)
    assert a.model == "llama3.1-8b"
