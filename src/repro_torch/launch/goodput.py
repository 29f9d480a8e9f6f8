"""GoodServe's decision path on the port: fit the MoE output-length
predictor, measure (or load) the engine's latency profile, and route a
mixed agentic workload over a heterogeneous pool under each router,
reporting goodput and the SLO-violation ratio.

Counterpart of ``examples/quickstart.py`` and the loop of
``benchmarks/fig6_end_to_end.py``:

1. fit ``MoEPredictor`` on ``train_corpus(n=2000, seed=1)`` on the device
   (40 epochs, lr 1e-3) and report its held-out MAE beside
   ``HistoryPredictor``'s;
2. measure a ``LatencyProfile`` of the port's engine on llama3.1-8b
   (``measured-cuda`` on the card), or load one with ``--profile``;
3. simulate ``make_workload(n, rps=10, slo_scale, model="llama3.1-8b",
   seed=3)`` under the 8 routers of fig6 over two pools: the paper's
   (H800, A800, A40, V100 on the analytic roofline) and the same with an
   H100 in place of the H800, whose iteration times come from the profile;
4. print one row per (pool, SLO scale, router), and GoodServe's margin
   over the best baseline per (pool, scale);
5. run the rest of the control plane on the same trace over the pool
   with the profiled H100 (``policy_runs``): admission control, the
   reactive pool controller, the fairness policy with an abusive tenant,
   four sharded gateway replicas over stale views, and the bandit router
   warm-started from a recorded decision trace, with its doubly-robust
   off-policy estimate beside its live what-if replay.

  PYTHONPATH=src python -m repro_torch.launch.goodput           # full, CUDA
  PYTHONPATH=src python -m repro_torch.launch.goodput --device cpu \\
      --size reduced                                          # CPU smoke

``full`` fits the paper-scale predictor (~44.7M parameters) and profiles
the full-width llama3.1-8b engine in bf16; ``reduced`` fits the fast
scale and profiles the reduced config in fp32 (a ``measured-cpu``
profile on the CPU: plumbing, not a capability).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.bench.profile import (LatencyProfile, analytic_profile,
                                       measure_engine_profile)
from repro_torch.cluster import hardware as hwlib
from repro_torch.cluster.simulator import Cluster, Instance, Simulator
from repro_torch.cluster.workload import (TenantSpec, assign_tenants,
                                         make_workload, train_corpus)
from repro_torch.configs import get_config, reduce_config
from repro_torch.core.control_plane import Beliefs, ControlPlane
from repro_torch.core.controller import (AdmissionController,
                                         ReactivePoolController)
from repro_torch.core.fairness import FairnessPolicy
from repro_torch.core.learned_router import BanditRouter
from repro_torch.core.metrics import summarize, summarize_elastic
from repro_torch.core.replay import (dr_estimate, realized_value,
                                     replay_whatif)
from repro_torch.core.sharded_plane import make_sharded_plane
from repro_torch.core.predictor import (FAST_SCALE, PAPER_SCALE,
                                        HistoryPredictor, MoEPredictor,
                                        evaluate_mae)
from repro_torch.core.router import make_router
from repro_torch.device import resolve_device, synchronize

MODEL = "llama3.1-8b"
ROUTERS = ["random", "round_robin", "least_request", "lowest_tpm",
           "prefix_cache", "preble", "llumnix", "goodserve"]
POOLS = {"paper": hwlib.PAPER_CLUSTER,                # analytic roofline
         "h100": ("H100",) + tuple(hwlib.PAPER_CLUSTER[1:])}
PROFILED = "H100"

# full: paper-scale predictor, full-width engine on the card;
# reduced: the CPU smoke size
SIZES: Dict[str, dict] = {
    "full": dict(scale=PAPER_SCALE, dtype=torch.bfloat16,
                 batches=(1, 2, 4, 8), ctxs=(256, 1024, 2048, 3968),
                 chunks=(128, 512, 1024, 2048), max_len=4096,
                 decode_iters=32),
    "reduced": dict(scale=FAST_SCALE, dtype=torch.float32,
                    batches=(1, 2), ctxs=(16, 32), chunks=(8, 16, 32),
                    max_len=None, decode_iters=4),
}


def card_line() -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the first card, or None
    where there is no ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return None
    return out.strip().splitlines()[0]


def fit_predictor(size: str, device):
    """The quickstart's predictor, fitted on the device.  Returns it and a
    report: parameter count, fit wall time, held-out MAE (``n=300,
    seed=9``) beside ``HistoryPredictor``'s, and the median latency of one
    ``predict`` of one request."""
    dev = resolve_device(device)
    corpus = train_corpus(n=2000, seed=1)
    pred = MoEPredictor(num_experts=9, scale=SIZES[size]["scale"],
                        device=dev)
    synchronize(dev)
    t0 = time.perf_counter()
    pred.fit(corpus, epochs=40, lr=1e-3)
    synchronize(dev)
    fit_s = time.perf_counter() - t0
    test = train_corpus(n=300, seed=9)
    truth = np.array([r.output_len for r in test], np.float32)
    hist = HistoryPredictor().fit(corpus)
    one = []
    for r in test:
        t0 = time.perf_counter()
        pred.predict_requests([r])          # reads the result back: synced
        one.append(time.perf_counter() - t0)
    return pred, {
        "n_params": pred.n_params(), "fit_s": fit_s,
        "mae": evaluate_mae(pred.predict_requests(test), truth),
        "history_mae": evaluate_mae(hist.predict_requests(test), truth),
        "mean_output": float(truth.mean()),
        "predict_ms_p50": statistics.median(one) * 1e3}


def profiled_config(size: str):
    """llama3.1-8b at full width, or reduced for the ``reduced`` size."""
    cfg = get_config(MODEL)
    return reduce_config(cfg) if size == "reduced" else cfg


def measure_profile(size: str, device) -> LatencyProfile:
    """The port's engine on llama3.1-8b (full width or reduced) over the
    size's grid, as the H100 entry's profile."""
    s = SIZES[size]
    return measure_engine_profile(
        profiled_config(size), hwlib.GPUS[PROFILED], batches=s["batches"],
        ctxs=s["ctxs"], chunks=s["chunks"], decode_iters=s["decode_iters"],
        dtype=s["dtype"], max_len=s["max_len"],
        meta={"nvidia_smi": card_line(), "size": size}, device=device)


def load_profile(path, size: str) -> LatencyProfile:
    """A saved profile for the H100 slot: it must be of the H100 entry and
    of the model that ``measure_profile(size)`` measures."""
    prof = LatencyProfile.load(path)
    want = profiled_config(size).name
    if prof.hardware != PROFILED or prof.model != want:
        raise ValueError(f"{path} profiles {prof.model} on {prof.hardware}; "
                         f"the {PROFILED} slot needs {want} on {PROFILED}")
    return prof


def analytic_beside(prof: LatencyProfile) -> LatencyProfile:
    """The analytic H800 profile on the profiled model's full-width
    footprint, at the measured grid's points."""
    return analytic_profile(
        hwlib.GPUS["H800"], hwlib.footprint(MODEL),
        batches=[int(b) for b in prof.decode_batches], ctxs=prof.decode_ctxs,
        chunks=[int(n) for n in prof.prefill_tokens])


def build_pool(pool: str, prof: Optional[LatencyProfile]) -> Cluster:
    """``build_paper_cluster`` over the pool's catalog entries; the H100,
    where the pool has one, runs on ``prof``."""
    fp = hwlib.footprint(MODEL)
    gpus = POOLS[pool]
    instances = [Instance(i, hwlib.GPUS[g], fp) for i, g in enumerate(gpus)]
    profiles = {PROFILED: prof} if PROFILED in gpus else None
    return Cluster(instances, profiles=profiles)


def run_goodput(predictor, prof: Optional[LatencyProfile], *, n: int = 400,
                scales: Sequence[float] = (1.0, 2.0, 3.0),
                routers: Sequence[str] = ROUTERS) -> List[dict]:
    """fig6's loop over both pools: one row per (pool, scale, router) with
    ``summarize``'s metrics and the simulation's wall time, then one
    ``margin`` row per (pool, scale): GoodServe's goodput over the best
    baseline's, minus one (None where no baseline has goodput)."""
    rows = []
    for pool in POOLS:
        for scale in scales:
            best, gs = 0.0, None
            for name in routers:
                reqs = make_workload(n=n, rps=10.0, slo_scale=scale,
                                     model=MODEL, seed=3)
                router = make_router(
                    name, predictor=predictor if name == "goodserve" else None)
                sim = Simulator(build_pool(pool, prof), router, reqs, tau=50)
                t0 = time.perf_counter()
                out, dur = sim.run()
                s = summarize(out, dur)
                rows.append({"pool": pool, "slo_scale": scale,
                             "router": name, **s,
                             "sim_s": time.perf_counter() - t0})
                if name == "goodserve":
                    gs = s["goodput_rps"]
                else:
                    best = max(best, s["goodput_rps"])
            if gs is not None:
                rows.append({"pool": pool, "slo_scale": scale,
                             "margin": gs / best - 1 if best > 0 else None,
                             "best_baseline": best, "goodserve": gs})
    return rows


# fig18's tenant mix: 12 Zipf-skewed tenants, tenant 0 an abuser that
# sends half the traffic as best effort
TENANTS = TenantSpec(n_tenants=12, zipf_a=1.1, abuser=0, abuser_share=0.5,
                     abuser_class="best_effort")
POLICIES = ["admission", "reactive", "fairness", "sharded", "bandit"]
POLICY_SLO_SCALE = 2.0
SYNC_INTERVAL_S = 1.0    # the sharded replicas' view sync
TRAIN_SEED = 91          # the bandit's exploration trace, never evaluated


def accounting(out) -> dict:
    """Where each request ended: finished, or failed by its own admission
    shed, fairness throttle or lost capacity, or cascaded from an
    ancestor's rejection; ``open`` counts requests that did neither."""
    acc = dict(finished=0, shed=0, throttled=0, cascaded=0, lost=0, open=0)
    own = {"shed": "shed", "throttle": "throttled", "lost": "lost"}
    for sr in out:
        if sr.finished_at is not None:
            acc["finished"] += 1
        elif sr.state == "failed":
            tags = [ev for _, ev, _ in sr.journey]
            kind = next((own[t] for t in tags if t in own), None)
            if kind is None and any(t.startswith("cascade:") for t in tags):
                kind = "cascaded"
            acc[kind or "lost"] += 1
        else:
            acc["open"] += 1
    return acc


def _bandit(predictor, eps: float, seed: int, state=None) -> BanditRouter:
    b = BanditRouter(predictor=predictor, eps=eps, seed=seed)
    if state is not None:
        b.load_state(state)
        b.eps = eps
    return b


def policy_runs(predictor, prof: Optional[LatencyProfile], *,
                n: int = 400) -> List[dict]:
    """The rest of GoodServe's control plane on fig6's trace (``n``
    requests at 10/s, seed 3, SLO scale 2) over the pool with the
    profiled H100, one row per policy with ``summarize_elastic``'s
    metrics and ``accounting``:

    * ``admission``: GoodServe with early-shed admission (fig13's margin 3);
    * ``reactive``: GoodServe with ``ReactivePoolController``'s defaults;
    * ``fairness``: fig18's fair plane on the trace tagged with an abusive
      tenant (``assign_tenants``);
    * ``sharded``: four GoodServe gateway replicas, each with its own
      beliefs, over views synced every second;
    * ``bandit``: fig20's ``train_offline``: a bandit explores (eps 0.5)
      on another seed's trace with ``record=True``, a second one is
      warm-started from that trace and serves this one (eps 0.3, recorded);
      its greedy posterior's ``dr_estimate`` on the recorded trace sits
      beside the value of its live ``replay_whatif`` on the same trace.
    """
    def pool():
        return build_pool("h100", prof)

    def trace(seed=3):
        return make_workload(n=n, rps=10.0, slo_scale=POLICY_SLO_SCALE,
                             model=MODEL, seed=seed)

    def goodserve(beliefs=None):
        if beliefs is not None:
            return make_router("goodserve", beliefs=beliefs)
        return make_router("goodserve", predictor=predictor)

    rows = []
    for name in POLICIES:
        reqs, extra = trace(), {}
        if name == "admission":
            plane = ControlPlane(router=goodserve(), admission=
                                 AdmissionController(predictor, margin=3.0))
        elif name == "reactive":
            ctl = ReactivePoolController()
            plane = ControlPlane(router=goodserve(), pool=ctl)
        elif name == "fairness":
            assign_tenants(reqs, TENANTS, seed=4)
            beliefs = Beliefs(predictor=predictor)
            plane = ControlPlane(
                router=goodserve(beliefs), beliefs=beliefs,
                admission=AdmissionController(beliefs=beliefs, margin=3.0),
                fairness=FairnessPolicy(
                    quantum_tps=40000.0, burst_s=2.0, overload_pending=4.0,
                    class_shed={"best_effort": 16.0, "standard": 32.0},
                    preempt=True, park_timeout_s=15.0, release_pending=4.0))
        elif name == "sharded":
            def replica(_i):
                beliefs = Beliefs(predictor=predictor)
                return ControlPlane(router=goodserve(beliefs),
                                    beliefs=beliefs)
            plane = make_sharded_plane(4, replica,
                                       sync_interval_s=SYNC_INTERVAL_S)
        elif name == "bandit":
            explore = ControlPlane(router=_bandit(predictor, 0.5, seed=1),
                                   record=True)
            Simulator(pool(), explore, trace(TRAIN_SEED), tau=50).run()
            logged = explore.trace
            warm = _bandit(predictor, 0.3, seed=2)
            warm.warm_start(logged)
            plane = ControlPlane(router=warm, record=True)
        cluster = pool()
        sim = Simulator(cluster, plane, reqs, tau=50)
        t0 = time.perf_counter()
        out, dur = sim.run()
        sim_s = time.perf_counter() - t0
        if name == "reactive":
            extra["pool_events"] = [list(e) for e in ctl.events]
        elif name == "fairness":
            fair = plane.fairness
            extra.update(throttles=len(fair.throttle_log),
                         class_sheds=len(fair.shed_log),
                         preempted_parked=len(fair.preempt_log),
                         released=len(fair.release_log))
        elif name == "sharded":
            extra.update(replicas=len(plane.shards),
                         sync_interval_s=SYNC_INTERVAL_S,
                         conflicts=len(plane.conflict_log),
                         max_staleness_s=max(sh.max_staleness
                                             for sh in plane.shards))
        elif name == "bandit":
            state, recorded = warm.state(), plane.trace
            est = dr_estimate(recorded,
                              _bandit(predictor, 0.0, seed=8, state=state))
            live = realized_value(replay_whatif(
                recorded, lambda c: ControlPlane(
                    router=_bandit(predictor, 0.0, seed=8, state=state)),
                pool), recorded)
            extra.update(dr_value=est["value"], whatif_value=live,
                         dr_direct=est["direct"],
                         dr_match_rate=est["match_rate"],
                         warm_start_events=len(logged.events))
        rows.append({"policy": name, "pool": "h100",
                     "slo_scale": POLICY_SLO_SCALE,
                     **summarize_elastic(out, dur, cluster),
                     "accounting": accounting(out), **extra,
                     "sim_s": sim_s})
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", choices=sorted(SIZES), default="full")
    ap.add_argument("--profile", help="load this profile JSON instead of "
                    "measuring one")
    ap.add_argument("--slo-scales", type=float, nargs="+",
                    default=[1.0, 2.0, 3.0])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    pred, fit = fit_predictor(args.size, dev)
    print(f"predictor: {fit['n_params']:,} params, fit {fit['fit_s']:.1f}s "
          f"on {dev}, MAE {fit['mae']:.1f} tokens (history "
          f"{fit['history_mae']:.1f}; mean output {fit['mean_output']:.0f}),"
          f" predict {fit['predict_ms_p50']:.2f} ms at batch 1")
    prof = (load_profile(args.profile, args.size) if args.profile
            else measure_profile(args.size, dev))
    print(f"profile: {prof.hardware} {prof.model} {prof.provenance}; decode "
          f"s {json.dumps(prof.decode_s)}; prefill s "
          f"{json.dumps(prof.prefill_s)}; analytic (unmeasured) points "
          f"{prof.meta.get('analytic_points')}")

    rows = run_goodput(pred, prof, scales=args.slo_scales)
    print(f"{'pool':6s} {'slo':>4s} {'router':14s} {'goodput/s':>10s} "
          f"{'viol%':>7s} {'done':>5s}")
    for r in rows:
        if "margin" in r:
            gain = ("no baseline has goodput" if r["margin"] is None
                    else f"{100 * r['margin']:+.1f}% goodput")
            print(f"{r['pool']:6s} {r['slo_scale']:4.1f} GoodServe vs best "
                  f"baseline: {gain}")
        else:
            print(f"{r['pool']:6s} {r['slo_scale']:4.1f} {r['router']:14s} "
                  f"{r['goodput_rps']:10.3f} "
                  f"{100 * r['violation_ratio']:6.1f}% {r['n_finished']:5d}")
    policies = policy_runs(pred, prof)
    for r in policies:
        acc = " ".join(f"{k}={v}" for k, v in r["accounting"].items())
        print(f"h100   {r['slo_scale']:4.1f} {r['policy']:14s} "
              f"{r['goodput_rps']:10.3f} {100 * r['violation_ratio']:6.1f}% "
              f"{acc}")
    return {"predictor": pred, "fit": fit, "profile": prof, "rows": rows,
            "policies": policies}


if __name__ == "__main__":
    main()
