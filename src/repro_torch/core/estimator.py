"""EMA-smoothed, black-box instance-capability estimation (paper Sec. 3.3).

Copy of ``repro/core/estimator.py`` (plain Python), kept in the port so
that it imports nothing of ``repro``.

The estimator sees only *observable timing events* — request wait times,
prefill durations, decode iteration durations — never engine internals
(batch size, GPU type, queue policy).  Per the paper: batched serving +
rarely-changing local config means per-iteration time is stable over short
horizons (law of large numbers), so recent-past EMAs suffice; the order of
instance preference is what must be right, not the absolute values.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass
class InstanceEstimate:
    q: float = 0.05    # expected queuing delay, seconds
    p: float = 1e-4    # per-token prefill latency, seconds
    d: float = 0.03    # per-token decode latency (TPOT), seconds
    n_obs: int = 0


class EMAEstimator:
    """GPUStatusMonitor: maintains (q_g, p_g, d_g) per instance.

    Cold start: an instance with no observations yet is born at either
    the hardcoded :class:`InstanceEstimate` defaults or — when a measured
    latency-profile prior has been registered via ``set_prior`` — the
    profile-derived (q, p, d), with
    ``n_obs`` pre-credited so routers rank it instead of exploring it.
    Priors only seed the FIRST estimate; observations then EMA over them
    exactly as before."""

    def __init__(self, alpha: float = 0.3,
                 priors: Optional[Dict[int, InstanceEstimate]] = None):
        self.alpha = alpha
        self.est: Dict[int, InstanceEstimate] = {}
        self.priors: Dict[int, InstanceEstimate] = dict(priors or {})

    def set_prior(self, gid: int, prior: InstanceEstimate):
        """Register a cold-start prior for ``gid``; a no-op for an
        instance that already has live estimates."""
        self.priors[gid] = prior

    def _get(self, gid: int) -> InstanceEstimate:
        if gid not in self.est:
            prior = self.priors.get(gid)
            self.est[gid] = (dataclasses.replace(prior)
                             if prior is not None else InstanceEstimate())
        return self.est[gid]

    def _ema(self, old: float, new: float) -> float:
        return self.alpha * new + (1 - self.alpha) * old

    # -- observation hooks (called by the serving engine / simulator) -------

    def observe_queue_wait(self, gid: int, wait_s: float):
        e = self._get(gid)
        e.q = self._ema(e.q, wait_s)
        e.n_obs += 1

    def observe_prefill(self, gid: int, n_tokens: int, dt_s: float):
        if n_tokens <= 0:
            return
        e = self._get(gid)
        e.p = self._ema(e.p, dt_s / n_tokens)
        e.n_obs += 1

    def observe_decode_iter(self, gid: int, dt_s: float):
        """One engine iteration advanced every running request by one
        token, so the per-request TPOT observation is the iteration time."""
        e = self._get(gid)
        e.d = self._ema(e.d, dt_s)
        e.n_obs += 1

    # -- queries --------------------------------------------------------------

    def snapshot(self, gid: int) -> InstanceEstimate:
        return self._get(gid)

    # -- state snapshot (determinism fingerprints, checkpoints) --------------

    def state(self) -> dict:
        """JSON-able snapshot of every live estimate, keys sorted so the
        repr is stable across runs that touched instances in different
        orders."""
        return {str(g): [e.q, e.p, e.d, e.n_obs]
                for g, e in sorted(self.est.items())}

    def load_state(self, st: dict):
        self.est = {int(g): InstanceEstimate(q=v[0], p=v[1], d=v[2],
                                             n_obs=int(v[3]))
                    for g, v in st.items()}

    def expected_latency(self, gid: int, input_len: int, pred_out: float,
                         prefix_hit: int = 0) -> float:
        """T(r,g) = q_g + p_g * (L_in - H) + d_g * L_out   (paper Eq. 2)."""
        e = self._get(gid)
        return (e.q + e.p * max(input_len - prefix_hit, 0)
                + e.d * max(pred_out, 1.0))
