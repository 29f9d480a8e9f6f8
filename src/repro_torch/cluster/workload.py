"""Agentic workload generation.

Copy of ``repro/cluster/workload.py`` (numpy and plain Python),
kept in the port so that it imports nothing of ``repro``.  Its imports
and references name ``repro_torch`` where the reference names
``repro``; any other line that differs carries a comment saying so.
Everything else, float expressions and iteration orders included, is
as written there.

The paper's workload suite mixes BIRD-bench (text-to-SQL), SWE-bench
(repo repair) and LiveCodeBench (code generation), replaying Mooncake
production arrival traces.  Those corpora aren't available offline, so we
generate a statistically-matched synthetic suite (DESIGN.md §8.4): three
task families with family-specific vocabulary (so TF-IDF features carry
task-type signal — the paper's "implicit precondition"), family-specific
output-length distributions, and within-family structure (output length
correlates with prompt complexity markers) plus irreducible noise.

SLOs follow the paper's methodology: median solo execution time on the
mid-tier GPU (A800), scaled by a relaxation factor.

Agentic multi-step workflows (the paper's core scenario)
--------------------------------------------------------
``make_workflow_workload`` emits DAG-structured sessions instead of
independent requests.  Three templates cover the agentic shapes the
paper targets:

  * ``tool_chain``  — linear chain of 3..6 tool-call steps,
  * ``reflection``  — draft -> critique -> revise loops (critiques short),
  * ``fanout``      — plan -> m parallel tool steps -> synthesize join.

Step *k+1*'s prompt embeds step *k*'s output, so context (and the
shared session prefix an instance can cache) grows along the chain;
the SLO is a single **per-workflow deadline** derived from the solo
critical-path time on the reference GPU times ``slo_scale``.  Knobs:
``n_workflows``, ``rps`` (workflow arrivals/s), ``slo_scale``,
``kind_mix`` (template probabilities), ``arrival`` process, and
``seed``.  Steps carry DAG structure (``wid``/``step``/``parents``/
``downstream``) and a ``session`` id for KV/prefix affinity; only
*structure* is visible to routers — ground-truth lengths stay hidden.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.cluster import hardware as hwlib

# ---------------------------------------------------------------------------
# Task families
# ---------------------------------------------------------------------------

_FAMILY_WORDS = {
    "sql": ("select table join schema column database query aggregate "
            "group filter index rows primary foreign key bird order "
            "having count distinct update".split()),
    "code": ("function class implement python algorithm return list "
             "array loop recursion test case solution leetcode codegen "
             "complexity string integer dynamic programming parse".split()),
    "swe": ("repository issue bug patch diff traceback module import "
            "fix regression test suite commit branch merge refactor "
            "dependency stack error exception file".split()),
}
_SHARED_WORDS = ("the a an of to in for with on and or is are that this "
                 "please given should must can will use write find".split())


@dataclasses.dataclass
class Request:
    rid: int
    family: str
    prompt: str
    input_len: int
    output_len: int           # ground truth (hidden from the router)
    arrival: float
    slo: float = 0.0          # absolute E2E deadline duration (seconds)
    tier: str = ""            # SLO tier ("tight"/"relaxed" for tuple
                              # slo_scale, "uniform" for the scalar setup)
                              # — lets benchmarks attribute violations
    prefix_group: int = 0     # shared-prompt-prefix group (for prefix cache)
    # -- multi-tenant identity (client-declared, proxy-visible) --
    tenant: int = -1          # tenant id (-1 = anonymous single-tenant)
    slo_class: str = ""       # "interactive" | "standard" | "best_effort"
                              # ("" = unclassed: fairness-neutral)
    region: str = ""          # origin region of the arrival ("" = no
                              # geographic affinity) — region-aware
                              # routers prefer serving near the client
    # -- agentic-workflow structure (visible to routers; lengths are not) --
    wid: int = -1             # workflow id (-1 = standalone request)
    step: int = 0             # step index within the workflow DAG
    parents: Tuple[int, ...] = ()   # step indices this step depends on
    downstream: int = 0       # longest chain of steps remaining AFTER this
    session: int = -1         # session id for KV/prefix-cache affinity
    # first-parent ancestor chain, nearest first: only THESE steps'
    # contexts are contiguous prefixes of this step's prompt (a fanout
    # sibling's context is in the same session but NOT a prefix)
    prefix_chain: Tuple[int, ...] = ()
    deadline_t: Optional[float] = None  # absolute per-WORKFLOW deadline


@dataclasses.dataclass(frozen=True)
class FamilySpec:
    name: str
    in_mean: float
    in_std: float
    out_mu: float             # lognormal params for base output length
    out_sigma: float
    complexity_gain: float    # extra output tokens per complexity marker
    bimodal_frac: float = 0.0  # fraction of "long tail" episodes
    bimodal_mult: float = 4.0


# Length statistics calibrated to the paper's benchmark mix: BIRD text-to-
# SQL outputs are short (~tens of tokens), LiveCodeBench solutions a few
# hundred, SWE-bench patches short-with-a-long-exploration-tail.  At these
# scales the paper's 4-GPU testbed at 10 rps runs moderately loaded — the
# regime where SLO-aware routing differentiates (DESIGN.md §8.4).
FAMILIES = {
    "sql": FamilySpec("sql", 300, 90, np.log(70), 0.40, 4.0),
    "code": FamilySpec("code", 450, 130, np.log(260), 0.50, 10.0),
    "swe": FamilySpec("swe", 900, 250, np.log(120), 0.45, 8.0,
                      bimodal_frac=0.2, bimodal_mult=3.0),
}


def _make_prompt(rng, fam: FamilySpec, complexity: int) -> str:
    words = []
    fam_pool = _FAMILY_WORDS[fam.name]
    n_words = max(int(rng.normal(40, 10)), 12)
    for _ in range(n_words):
        pool = fam_pool if rng.random() < 0.45 else _SHARED_WORDS
        words.append(pool[rng.integers(len(pool))])
    words += ["requirement"] * complexity
    return " ".join(words)


def sample_request(rng, rid: int, family: Optional[str] = None) -> Request:
    name = family or ("sql", "code", "swe")[rng.integers(3)]
    fam = FAMILIES[name]
    complexity = int(rng.integers(0, 8))
    input_len = max(int(rng.normal(fam.in_mean, fam.in_std)), 32)
    base = rng.lognormal(fam.out_mu, fam.out_sigma)
    out = base + fam.complexity_gain * complexity * rng.uniform(0.6, 1.4)
    if fam.bimodal_frac and rng.random() < fam.bimodal_frac:
        out *= fam.bimodal_mult
    output_len = int(np.clip(out, 8, 8192))
    return Request(rid=rid, family=name,
                   prompt=_make_prompt(rng, fam, complexity),
                   input_len=input_len, output_len=output_len,
                   arrival=0.0, prefix_group=int(rng.integers(0, 32)))


# ---------------------------------------------------------------------------
# Arrival processes
# ---------------------------------------------------------------------------

def poisson_arrivals(rng, n: int, rps: float) -> np.ndarray:
    return np.cumsum(rng.exponential(1.0 / rps, size=n))


def mooncake_like_arrivals(rng, n: int, rps: float, cv: float = 1.3,
                           burst_period: float = 60.0) -> np.ndarray:
    """Bursty production-trace replay: gamma interarrivals (CV > 1)
    modulated by a slow sinusoidal load swing, as in Mooncake's public
    trace characterization (high short-term burstiness + diurnal drift)."""
    shape = 1.0 / (cv * cv)
    inter = rng.gamma(shape, 1.0 / (rps * shape), size=n)
    t = np.cumsum(inter)
    # slow modulation: resample interarrivals where load swings high
    mod = 1.0 + 0.35 * np.sin(2 * np.pi * t / burst_period)
    return np.cumsum(inter / mod)


def diurnal_arrivals(rng, n: int, rps: float, period: float = 600.0,
                     amplitude: float = 0.7, cv: float = 1.2,
                     floor: float = 0.05) -> np.ndarray:
    """Diurnal/bursty pattern for the elastic-pool scenario: instantaneous
    rate lambda(t) = rps * (1 + amplitude * sin(2 pi t / period - pi/2))
    — starts at the trough, swells to (1 + amplitude) x rps mid-period —
    with gamma (CV > 1) short-term burstiness on top.  This is the
    workload where a statically-sized pool either overpays at the trough
    or misses SLOs at the peak (SageServe's motivating regime)."""
    shape = 1.0 / (cv * cv)
    t = 0.0
    out = np.empty(n)
    for i in range(n):
        lam = rps * max(1.0 + amplitude
                        * np.sin(2 * np.pi * t / period - np.pi / 2), floor)
        t += rng.gamma(shape, 1.0 / (lam * shape))
        out[i] = t
    return out


def _arrival_times(rng, n: int, rps: float, arrival: str, **kw) -> np.ndarray:
    if arrival == "mooncake":
        return mooncake_like_arrivals(rng, n, rps, **kw)
    if arrival == "diurnal":
        return diurnal_arrivals(rng, n, rps, **kw)
    if arrival == "poisson":
        return poisson_arrivals(rng, n, rps)
    raise KeyError(arrival)


# ---------------------------------------------------------------------------
# Workload assembly + SLO assignment (paper Sec. 4.1)
# ---------------------------------------------------------------------------

def solo_latency(hw: hwlib.HardwareSpec, fp: hwlib.ModelFootprint,
                 req: Request) -> float:
    """E2E latency of the request running alone on ``hw``."""
    t = hwlib.prefill_time(hw, fp, req.input_len)
    # decode one token at a time at batch=1
    t += req.output_len * hwlib.decode_iteration_time(
        hw, fp, 1, req.input_len + req.output_len / 2)
    return t


def make_workload(n: int = 600, rps: float = 10.0, slo_scale=2.0,
                  model: str = "llama3.1-8b", seed: int = 0,
                  arrival: str = "mooncake",
                  reference_gpu: str = "A800",
                  arrival_kw: Optional[Dict] = None,
                  drift: Optional[Dict] = None) -> List[Request]:
    """``slo_scale`` may be a scalar (uniform tier, the paper's setup) or
    a ``(lo, hi)`` tuple: each request draws its relaxation factor
    uniformly, modeling mixed SLO tiers (interactive vs batch callers) —
    the regime where slack-aware routing has real decisions to make.

    ``drift`` injects a mid-run output-length distribution shift (the
    regime runtime rectification exists for), e.g. ``{"at": 0.5,
    "out_mult": 2.5}``: every request arriving after ``at`` x the
    arrival span has its ground-truth output length multiplied by
    ``out_mult``.  Prompts and input lengths are untouched, so a
    predictor trained (or configured) on the pre-drift distribution
    keeps seeing familiar features while reality shifts under it; SLOs
    are assigned from the *post-drift* lengths, so the work stays
    feasible — it is the router's belief that breaks, not the
    workload."""
    rng = np.random.default_rng(seed)
    fp = hwlib.footprint(model)
    ref = hwlib.GPUS[reference_gpu]
    reqs = [sample_request(rng, i) for i in range(n)]
    arr = _arrival_times(rng, n, rps, arrival, **(arrival_kw or {}))
    if drift:
        at = float(drift.get("at", 0.5))
        mult = float(drift.get("out_mult", 2.5))
        t_drift = at * float(arr[-1])
        for r, a in zip(reqs, arr):
            if a >= t_drift:
                r.output_len = int(np.clip(r.output_len * mult, 8, 8192))
    # the paper sets SLO = median solo time on the mid-tier GPU x scale,
    # measured per request (temperature 0 => deterministic lengths)
    for r, a in zip(reqs, arr):
        r.arrival = float(a)
        if isinstance(slo_scale, tuple):
            scale = rng.uniform(*slo_scale)
            r.tier = ("tight" if scale < sum(slo_scale) / 2.0
                      else "relaxed")
        else:
            scale = slo_scale
            r.tier = "uniform"
        r.slo = solo_latency(ref, fp, r) * scale
    return reqs


def train_corpus(n: int = 8680, seed: int = 1):
    """Predictor training corpus (the paper trains on 8,680 samples)."""
    rng = np.random.default_rng(seed)
    return [sample_request(rng, i) for i in range(n)]


# ---------------------------------------------------------------------------
# Multi-step agentic workflows (DAG-structured sessions)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Workflow:
    wid: int
    kind: str                 # tool_chain | reflection | fanout
    arrival: float
    deadline: float           # E2E deadline duration (seconds) for ALL steps
    steps: List[Request]

    @property
    def deadline_t(self) -> float:
        return self.arrival + self.deadline

    def roots(self) -> List[Request]:
        return [s for s in self.steps if not s.parents]


# Per-role output-length scaling: critiques are short, synthesis joins
# are longer than a single tool call.
_ROLE_OUT_SCALE = {"draft": 1.0, "critique": 0.35, "revise": 0.8,
                   "tool": 0.7, "plan": 0.4, "synth": 1.2}

_CTX_CAP = 6144               # max prefill length after context embedding


def _workflow_plan(rng, kind: str) -> List[Tuple[str, str, Tuple[int, ...]]]:
    """Return (family, role, parents) per step for one template."""
    if kind == "tool_chain":
        k = int(rng.integers(3, 7))
        fams = [("sql", "code", "swe")[rng.integers(3)] for _ in range(k)]
        return [(fams[i], "tool", () if i == 0 else (i - 1,))
                for i in range(k)]
    if kind == "reflection":
        rounds = int(rng.integers(1, 3))          # 1..2 critique/revise loops
        plan = [("code", "draft", ())]
        for _ in range(rounds):
            plan.append(("swe", "critique", (len(plan) - 1,)))
            plan.append(("code", "revise", (len(plan) - 1,)))
        return plan
    if kind == "fanout":
        m = int(rng.integers(2, 5))               # parallel tool calls
        plan = [("code", "plan", ())]
        plan += [(("sql", "swe")[rng.integers(2)], "tool", (0,))
                 for _ in range(m)]
        plan.append(("code", "synth", tuple(range(1, m + 1))))
        return plan
    raise KeyError(kind)


def _downstream_depths(plan) -> List[int]:
    """Longest chain of steps strictly below each node (reverse topo)."""
    n = len(plan)
    children: Dict[int, List[int]] = {i: [] for i in range(n)}
    for i, (_, _, parents) in enumerate(plan):
        for p in parents:
            children[p].append(i)
    depth = [0] * n
    for i in reversed(range(n)):
        depth[i] = max((1 + depth[c] for c in children[i]), default=0)
    return depth


def make_workflow(rng, wid: int, arrival: float, rid0: int,
                  kind: Optional[str] = None, slo_scale: float = 3.0,
                  model: str = "llama3.1-8b",
                  reference_gpu: str = "A800") -> Workflow:
    """One DAG session: step k+1's prompt embeds step k's output, so the
    prefill context grows along the chain and consecutive steps share the
    session's KV prefix.  The deadline covers the whole workflow: solo
    critical-path time on the reference GPU x ``slo_scale``."""
    kind = kind or ("tool_chain", "reflection", "fanout")[rng.integers(3)]
    plan = _workflow_plan(rng, kind)
    depths = _downstream_depths(plan)
    fp = hwlib.footprint(model)
    ref = hwlib.GPUS[reference_gpu]
    prefix_group = int(rng.integers(0, 32))      # shared system prompt

    steps: List[Request] = []
    for i, (family, role, parents) in enumerate(plan):
        base = sample_request(rng, rid0 + i, family)
        out = int(np.clip(base.output_len * _ROLE_OUT_SCALE[role], 8, 8192))
        # conversation context carried from parents: their full prefill
        # context plus the output each one appended
        ctx = sum(steps[p].input_len + steps[p].output_len for p in parents)
        input_len = int(min(base.input_len + ctx, _CTX_CAP))
        # the child prompt literally embeds the tail of each parent prompt
        # (standing in for "step k's output feeds step k+1")
        parent_tail = " ".join(
            w for p in parents for w in steps[p].prompt.split()[-24:])
        prompt = (parent_tail + " " + base.prompt).strip()
        chain = ((parents[0],) + steps[parents[0]].prefix_chain
                 if parents else ())
        steps.append(Request(
            rid=rid0 + i, family=family, prompt=prompt,
            input_len=input_len, output_len=out, arrival=arrival,
            prefix_group=prefix_group, wid=wid, step=i,
            parents=tuple(parents), downstream=depths[i], session=wid,
            prefix_chain=chain))

    # deadline = solo critical path on the reference GPU x slo_scale
    finish = [0.0] * len(steps)
    for i, s in enumerate(steps):
        start = max((finish[p] for p in s.parents), default=0.0)
        finish[i] = start + solo_latency(ref, fp, s)
    deadline = max(finish) * slo_scale
    for s in steps:
        s.slo = deadline
        s.deadline_t = arrival + deadline
    return Workflow(wid=wid, kind=kind, arrival=arrival,
                    deadline=deadline, steps=steps)


def make_workflow_workload(n_workflows: int = 80, rps: float = 2.0,
                           slo_scale: float = 3.0,
                           model: str = "llama3.1-8b", seed: int = 0,
                           arrival: str = "mooncake",
                           kind_mix: Optional[Dict[str, float]] = None,
                           reference_gpu: str = "A800",
                           arrival_kw: Optional[Dict] = None
                           ) -> Tuple[List[Request], List[Workflow]]:
    """DAG-structured agentic workload: returns (all step requests in
    topological order per workflow, workflow descriptors).  ``rps`` is
    *workflow* arrivals per second; non-root steps materialize in the
    simulator only once their parents complete."""
    rng = np.random.default_rng(seed)
    arr = _arrival_times(rng, n_workflows, rps, arrival,
                         **(arrival_kw or {}))
    kinds = list(kind_mix) if kind_mix else None
    probs = None
    if kind_mix:
        total = sum(kind_mix.values())
        probs = [kind_mix[k] / total for k in kinds]
    workflows, requests = [], []
    rid = 0
    for w in range(n_workflows):
        kind = (kinds[rng.choice(len(kinds), p=probs)] if kinds else None)
        wf = make_workflow(rng, w, float(arr[w]), rid, kind=kind,
                           slo_scale=slo_scale, model=model,
                           reference_gpu=reference_gpu)
        rid += len(wf.steps)
        workflows.append(wf)
        requests.extend(wf.steps)
    return requests, workflows


# ---------------------------------------------------------------------------
# Multi-tenant identity (FairServe-style skewed demand, AccelGen-style
# heterogeneous per-class SLO guarantees)
# ---------------------------------------------------------------------------

SLO_CLASSES = ("interactive", "standard", "best_effort")


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """How to paint an existing workload with tenant identities.

    Tagging is post-hoc with its OWN rng stream, so a workload generated
    from a given seed is byte-identical with or without tenants attached
    — the base draws are untouched and replay fingerprints stay stable.
    """
    n_tenants: int = 12
    zipf_a: float = 1.1            # demand skew across non-abuser tenants
    abuser: int = -1               # tenant id flooding the pool (-1: none)
    abuser_share: float = 0.5      # fraction of traffic the abuser owns
    abuser_class: str = "best_effort"
    # per-tenant SLO-class assignment weights (each tenant carries ONE class)
    class_mix: Tuple[Tuple[str, float], ...] = (
        ("interactive", 0.40), ("standard", 0.35), ("best_effort", 0.25))
    # per-class SLO relaxation on top of the base slo_scale: interactive
    # keeps the tight budget, best-effort tolerates a loose one
    class_slo_scale: Tuple[Tuple[str, float], ...] = (
        ("interactive", 1.0), ("standard", 1.3), ("best_effort", 2.0))


def _tenant_weights(spec: "TenantSpec") -> np.ndarray:
    ids = np.arange(spec.n_tenants, dtype=float)
    w = 1.0 / (ids + 1.0) ** spec.zipf_a
    if 0 <= spec.abuser < spec.n_tenants:
        w[spec.abuser] = 0.0
        w *= (1.0 - spec.abuser_share) / w.sum()
        w[spec.abuser] = spec.abuser_share
    else:
        w /= w.sum()
    return w


def assign_tenants(requests: List[Request], spec: TenantSpec, seed: int = 0,
                   workflows: Optional[List["Workflow"]] = None
                   ) -> List[Request]:
    """Tag ``requests`` in place with tenant ids and SLO classes.

    The tagging unit is a whole workflow when ``workflows`` is given
    (one tenant owns a DAG session end to end) and a single request
    otherwise.  Demand across tenants is Zipf-skewed; when
    ``spec.abuser >= 0`` that tenant's draw probability is pinned to
    ``abuser_share`` and the rest split the remainder Zipf-style.  Each
    tenant carries exactly one SLO class, whose relaxation factor
    multiplies the request SLO (and the workflow deadline), so classes
    carry genuinely heterogeneous guarantees.  Returns ``requests``.
    """
    rng = np.random.default_rng(seed)
    w = _tenant_weights(spec)
    names = [c for c, _ in spec.class_mix]
    mix = np.array([p for _, p in spec.class_mix], float)
    mix /= mix.sum()
    classes = {tn: names[int(rng.choice(len(names), p=mix))]
               for tn in range(spec.n_tenants)}
    if 0 <= spec.abuser < spec.n_tenants:
        classes[spec.abuser] = spec.abuser_class
    relax = dict(spec.class_slo_scale)

    def _draw():
        tn = int(rng.choice(spec.n_tenants, p=w))
        cls = classes[tn]
        return tn, cls, float(relax.get(cls, 1.0))

    tagged_ids = set()
    if workflows:
        for wf in workflows:
            tn, cls, m = _draw()
            wf.deadline *= m
            for s in wf.steps:
                s.tenant, s.slo_class = tn, cls
                s.slo = wf.deadline
                s.deadline_t = wf.arrival + wf.deadline
                tagged_ids.add(id(s))
    for r in requests:
        if id(r) in tagged_ids:
            continue
        tn, cls, m = _draw()
        r.tenant, r.slo_class = tn, cls
        r.slo *= m
        if r.deadline_t is not None:
            r.deadline_t = r.arrival + r.slo
    return requests


def assign_regions(requests: List[Request],
                   regions: Sequence[str],
                   weights: Optional[Sequence[float]] = None,
                   seed: int = 0,
                   workflows: Optional[List["Workflow"]] = None
                   ) -> List[Request]:
    """Paint a regional arrival mix onto an existing trace, post hoc
    and draw-preserving (own RNG stream — the base trace's draws are
    untouched, so a regional and a flat run share arrivals and
    lengths).  The tagging unit is a whole workflow when ``workflows``
    is given — a DAG session originates from one client in one region —
    and a single request otherwise.  ``weights`` skews the mix
    (uniform by default).  Returns ``requests``."""
    rng = np.random.default_rng(seed)
    w = np.array([1.0] * len(regions) if weights is None else weights,
                 float)
    w /= w.sum()

    def _draw() -> str:
        return regions[int(rng.choice(len(regions), p=w))]

    tagged_ids = set()
    if workflows:
        for wf in workflows:
            region = _draw()
            for s in wf.steps:
                s.region = region
                tagged_ids.add(id(s))
    for r in requests:
        if id(r) not in tagged_ids:
            r.region = _draw()
    return requests


def drop_tenant(requests: List[Request], tenant: int,
                workflows: Optional[List["Workflow"]] = None):
    """Remove one tenant's traffic, leaving everyone else's arrivals
    untouched — the counterfactual "no abuser" arm of a fairness run.
    Returns the filtered request list, or ``(requests, workflows)`` when
    workflows are given."""
    reqs = [r for r in requests if r.tenant != tenant]
    if workflows is None:
        return reqs
    wfs = [wf for wf in workflows
           if not (wf.steps and wf.steps[0].tenant == tenant)]
    return reqs, wfs
