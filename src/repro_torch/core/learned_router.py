"""BanditRouter: an online-learning contextual-bandit routing Policy.

Copy of ``repro/core/learned_router.py`` (numpy and plain Python),
kept in the port so that it imports nothing of ``repro``.  Its imports
and references name ``repro_torch`` where the reference names
``repro``; any other line that differs carries a comment saying so.
Everything else, float expressions and iteration orders included, is
as written there.

Lodestar (PAPERS.md) shows an online-learning router beating hand-tuned
policies once it can learn instance quality from observed completions;
this module is that learner for the GoodServe plane.  One LinUCB model
per **(hardware type, load bucket)** arm — arms generalize across
instances of one type at one load level, so a fresh elastic join scores
sensibly from its first request and the model transfers across pool
sizes — over the canonical proxy-visible feature vector shared with the
trace recorder (:data:`repro_torch.core.replay.FEATURE_NAMES`: queue depth,
EMA capability, rectified remaining work via the shared Beliefs bundle,
believed eviction risk, cross-region placement).  The reward is the
request's goodput contribution: 1 if it completed within its deadline,
0 on a miss — and 0 on every terminal failure (shed / cascade / lost),
settled through ``on_request_failed`` so doomed arms are learned, not
silently dropped.

Exploration is epsilon-greedy over the LinUCB scores with a
**deterministic draw discipline**: every decision with more than one
candidate consumes exactly one uniform from the router's seeded rng
(plus one integer draw on the explore branch), so a same-seed rerun
replays byte-identically (tests/test_torch_policies.py) and the logged
propensity of each action — ``eps/k`` plus ``1-eps`` on the greedy arm
— is exact, which is what the doubly-robust estimator in
:mod:`repro_torch.core.replay` divides by.

The posterior is a value, not a process: ``state()``/``load_state()``
round-trip every arm (and the exploration knobs) through JSON-able
dicts, so learned state enters determinism fingerprints, and
``warm_start(trace)`` fits the arms offline from a logged
DecisionTrace before the router ever goes live.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import replay as replaylib
from repro_torch.core.control_plane import Beliefs
from repro_torch.core.router import Router

__all__ = ["BanditRouter"]


def arm_key(hw_name: str, bucket: int) -> str:
    return f"{hw_name}|{bucket}"


class _LinUCBArm:
    """One ridge-regression bandit arm: A = lam*I + sum x xT, b = sum r x,
    score(x) = thetaT x + alpha * sqrt(xT A^-1 x).  The inverse is cached
    and invalidated on update (dim is 9; the solve is trivial)."""

    def __init__(self, dim: int, lam: float = 1.0):
        self.A = np.eye(dim) * lam
        self.b = np.zeros(dim)
        self.n = 0
        self._inv = None

    def _ainv(self):
        if self._inv is None:
            self._inv = np.linalg.inv(self.A)
        return self._inv

    def score(self, x, alpha: float) -> float:
        x = np.asarray(x, dtype=float)
        inv = self._ainv()
        theta = inv @ self.b
        width = float(np.sqrt(max(float(x @ inv @ x), 0.0)))
        return float(theta @ x) + alpha * width

    def update(self, x, reward: float):
        x = np.asarray(x, dtype=float)
        self.A += np.outer(x, x)
        self.b += float(reward) * x
        self.n += 1
        self._inv = None

    def state(self) -> dict:
        return {"A": self.A.tolist(), "b": self.b.tolist(), "n": self.n}

    @classmethod
    def from_state(cls, st: dict, lam: float = 1.0) -> "_LinUCBArm":
        A = np.asarray(st["A"], dtype=float)
        arm = cls(A.shape[0], lam)
        arm.A = A
        arm.b = np.asarray(st["b"], dtype=float)
        arm.n = int(st["n"])
        return arm


class BanditRouter(Router):
    """Contextual-bandit router (one LinUCB arm per hardware type x
    load bucket), epsilon-greedy with exact logged propensities.

    Estimation state follows the GoodServe convention: pass ONE shared
    ``beliefs`` bundle (the same object the plane and admission hold) or
    the legacy ``predictor``/``rectifier``/``evict_rates`` pieces and a
    private bundle is built.  The bundle sizes the decode feature
    (rectified remaining work) and prices the eviction-risk feature from
    the learned Gamma-Poisson posterior — the bandit then learns how
    much each feature *matters* instead of inheriting hand-tuned
    surcharges.
    """
    name = "bandit"

    def __init__(self, predictor=None, seed: int = 0, eps: float = 0.1,
                 alpha: float = 0.6, lam: float = 1.0, rectifier=None,
                 evict_rates=None, beliefs: Beliefs = None):
        super().__init__(seed)
        if beliefs is not None:
            if predictor is not None or rectifier is not None \
                    or evict_rates is not None:
                raise TypeError("pass beliefs OR the individual "
                                "predictor/rectifier/evict_rates pieces")
            self.beliefs = beliefs
        else:
            from repro_torch.core import rectify as rectlib
            if evict_rates is None:
                evict_rates = rectlib.EvictionRateEstimator()
            self.beliefs = Beliefs(predictor=predictor, rectifier=rectifier,
                                   evict_rates=evict_rates)
        self.eps = float(eps)
        self.alpha = float(alpha)
        self.lam = float(lam)
        self.dim = replaylib.FEATURE_DIM
        self.arms: dict = {}
        # rid -> (arm key, feature vector) awaiting its terminal reward;
        # a resubmission (failure victim, drain re-route) overwrites, so
        # the reward lands on the arm that actually served the request
        self._pending: dict = {}
        # propensity handshake with the trace recorder: set per routing
        # decision, matched by rid
        self.last_decision_info: dict = None

    # -- arms ---------------------------------------------------------------

    def _arm(self, key: str) -> _LinUCBArm:
        arm = self.arms.get(key)
        if arm is None:
            arm = self.arms[key] = _LinUCBArm(self.dim, self.lam)
        return arm

    def _peek(self, key: str) -> _LinUCBArm:
        """Read-only arm lookup (scoring a never-pulled arm must not
        grow ``state()``)."""
        return self.arms.get(key) or _LinUCBArm(self.dim, self.lam)

    def _predict(self, sr) -> float:
        # predictor-less planes get the same fixed prior the trace
        # recorder uses, so live features and logged features agree
        if self.beliefs.predictor is None:
            return replaylib.DEFAULT_PRED
        return self.beliefs.predict(sr)

    # -- live routing -------------------------------------------------------

    def _route(self, sr, t):
        views = self.targets(t)
        pred = self._predict(sr)
        sr.pred_out = pred
        if sr.pred_admit == 0.0:
            sr.pred_admit = pred
        slack = sr.deadline - t
        keys, xs, ranked = [], [], []
        for v in views:
            rate = self.beliefs.rate_per_hour(v.hw.name) if v.is_spot \
                else 0.0
            x = replaylib.feature_vector(v, sr.req.input_len, pred, slack,
                                         rate, sr.req.region)
            key = arm_key(v.hw.name, replaylib.load_bucket(v.pending))
            keys.append(key)
            xs.append(x)
            ranked.append((self._peek(key).score(x, self.alpha),
                           -v.pending, -v.iid))
        greedy = max(range(len(views)), key=lambda i: ranked[i])
        k = greedy
        if self.eps > 0.0 and len(views) > 1:
            # fixed draw discipline: exactly one uniform per decision,
            # one extra integer draw on the explore branch — the rng
            # stream depends only on the decision sequence, never on
            # scores, so same-seed reruns replay byte-identically
            if float(self.rng.random()) < self.eps:
                k = int(self.rng.integers(len(views)))
        if self.eps > 0.0 and len(views) > 1:
            propensity = self.eps / len(views) \
                + ((1.0 - self.eps) if k == greedy else 0.0)
        else:
            propensity = 1.0
        chosen = views[k]
        self._pending[sr.req.rid] = (keys[k], xs[k])
        self.last_decision_info = {"rid": int(sr.req.rid),
                                   "propensity": float(propensity),
                                   "greedy_gid": int(views[greedy].iid)}
        return chosen.iid

    # -- reward settlement --------------------------------------------------

    def _settle(self, sr, reward: float):
        got = self._pending.pop(sr.req.rid, None)
        if got is None:
            return
        key, x = got
        self._arm(key).update(x, reward)

    def on_request_done(self, sr, t):
        met = sr.finished_at is not None and t <= sr.deadline + 1e-9
        self._settle(sr, 1.0 if met else 0.0)

    def on_request_failed(self, sr, t):
        # terminal failures are ZERO-reward pulls, not unobserved ones:
        # an arm that sheds or strands its requests must learn that
        self._settle(sr, 0.0)

    # -- posterior snapshot (determinism fingerprints, checkpoints) ---------

    def state(self) -> dict:
        return {"eps": self.eps, "alpha": self.alpha, "lam": self.lam,
                "arms": {k: self.arms[k].state()
                         for k in sorted(self.arms)}}

    def load_state(self, st: dict):
        self.eps = float(st.get("eps", self.eps))
        self.alpha = float(st.get("alpha", self.alpha))
        self.lam = float(st.get("lam", self.lam))
        self.arms = {k: _LinUCBArm.from_state(v, self.lam)
                     for k, v in st.get("arms", {}).items()}

    # -- offline: warm-start and trace scoring ------------------------------

    def warm_start(self, trace) -> int:
        """Fit the arms from a logged DecisionTrace's routed events with
        settled outcomes (zero-reward failures included).  Returns the
        number of updates applied.  Call before going live — the arms
        start at the logging run's posterior instead of at the prior."""
        n = 0
        for e in trace.route_events():
            c = replaylib._cand(e, e["gid"])
            if c is None:
                continue
            self._arm(arm_key(c["hw"], c["bucket"])).update(
                c["x"], float(e["outcome"]["reward"]))
            n += 1
        return n

    def offline_choose(self, event: dict) -> int:
        """The GREEDY arm over a trace event's frozen candidate features
        — the target policy the doubly-robust estimator scores (the
        exploration mass is the logging policy's business, not the
        evaluated one's)."""
        cands = event.get("candidates") or []
        if not cands:
            return -1
        best = max(cands, key=lambda c: (
            self._peek(arm_key(c["hw"], c["bucket"])).score(c["x"],
                                                            self.alpha),
            -int(c["iid"])))
        return int(best["iid"])
