"""Output-length predictors (paper Sec. 3.2 + Fig. 8 baselines), in PyTorch.

Port of ``repro/core/predictor.py``.  ``MoEPredictor`` is the paper's
contribution: a gating router (2-layer MLP) over K expert MLPs (4 layers
each), trained in two phases — (1) partition half the data into K subsets
by discretizing input/output lengths into sqrt(K) tiers and train one
expert per subset; (2) freeze experts, train the router end-to-end on the
other half.  At the paper scale (K=9, feature dim 2048, expert hidden
1408/1024/512) this is ~44.7M parameters.

Baselines: ``SingleMLPPredictor`` (STAR-style 4-layer MLP),
``HistoryPredictor`` (Past-Future-style lookup over recent same-bucket
requests), and ``TransformerProxyPredictor`` (stand-in for the S^3
DistilBERT predictor: a small transformer encoder over token hashes).

What differs from the reference:

* the networks are ``nn.Module``s (``_MLP``, ``MoE``, ``_Encoder``) whose
  ``nn.Linear`` weights are the transpose of the reference's ``[in, out]``
  ``w``; :func:`predictor_params_from_jax` carries a JAX param tree over;
* ``_fit`` is a loop over ``torch.autograd`` gradients and the port's
  AdamW, with the reference's rules kept: the cosine schedule with 20
  warm-up steps, shuffles from ``np.random.default_rng(seed)``, the clip
  over the masked gradients, and weight decay on the frozen experts of
  phase 2 (their gradients are masked to zero, not left out);
* initial weights come from ``torch.Generator(seed)`` on the host (the
  same on every device); they cannot equal ``jax.random``'s;
* ``MoEPredictor``, ``SingleMLPPredictor`` and
  ``TransformerProxyPredictor`` take ``device`` (default ``"cuda"``):
  featurisation stays on the host, and ``predict`` moves one batch to the
  device and reads the result back.  Matmuls run in fp32 (TF32 stays at
  PyTorch's default, off);
* ``timed_predict`` synchronises the device before reading the clock.

``HistoryPredictor``, ``SessionAwarePredictor``, ``evaluate_mae`` and the
scales are copies.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.data.features import (TfIdfVectorizer, _hash_token,
                                       featurize)
from repro_torch.device import resolve_device, synchronize
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            init_opt_state)

# ---------------------------------------------------------------------------
# MLP plumbing
# ---------------------------------------------------------------------------


def _randn(g: torch.Generator, *shape) -> torch.Tensor:
    return torch.randn(shape, generator=g, dtype=torch.float32)


class _MLP(nn.Module):
    """``x @ w + b`` per layer with ReLU between layers; weights drawn as
    the reference draws them (normal · fan_in^-0.5, zero bias)."""

    def __init__(self, dims: Sequence[int], g: Optional[torch.Generator] = None):
        super().__init__()
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(dims[:-1], dims[1:]))
        if g is not None:
            with torch.no_grad():
                for lin in self.layers:
                    a = lin.in_features
                    lin.weight.copy_(_randn(g, a, lin.out_features).T
                                     * (a ** -0.5))
                    lin.bias.zero_()

    def forward(self, x):
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


class MoE(nn.Module):
    """A router MLP over K expert MLPs; ``forward`` returns the
    probability-weighted prediction and the router's probabilities."""

    def __init__(self, feat: int, router_hidden: int, expert_hidden,
                 num_experts: int, g: Optional[torch.Generator] = None):
        super().__init__()
        self.router = _MLP((feat, router_hidden, num_experts), g)
        edims = (feat,) + tuple(expert_hidden) + (1,)
        self.experts = nn.ModuleList(_MLP(edims, g)
                                     for _ in range(num_experts))

    def forward(self, x):
        probs = torch.softmax(self.router(x), dim=-1)             # [N, K]
        expert_out = torch.stack([e(x)[:, 0] for e in self.experts],
                                 dim=-1)                          # [N, K]
        return torch.sum(probs * expert_out, dim=-1), probs


def _fit(loss_fn: Callable, module: nn.Module, data, *, epochs: int,
         batch: int, lr: float, seed: int = 0,
         trainable: Optional[Mapping[str, float]] = None):
    """Minimal AdamW fit loop over ``module``'s parameters, updated in
    place.  ``trainable`` maps parameter names to a gradient multiplier
    (1.0 trains, 0.0 freezes); a frozen parameter still decays."""
    x, y = data
    n = x.shape[0]
    opt_cfg = AdamWConfig(lr=lr, weight_decay=0.01, warmup_steps=20,
                          total_steps=max(epochs * max(n // batch, 1), 1),
                          schedule="cosine")
    names, params = zip(*module.named_parameters())
    opt = init_opt_state([p.detach() for p in params])
    mult = None if trainable is None else [trainable[k] for k in names]
    rng = np.random.default_rng(seed)

    loss = torch.zeros(())
    for _ in range(epochs):
        order = rng.permutation(n)
        for s in range(0, n, batch):
            idx = torch.as_tensor(order[s:s + batch], device=x.device)
            loss = loss_fn(module, x[idx], y[idx])
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(params, grads)]
            if mult is not None:
                grads = [g * t for g, t in zip(grads, mult)]
            new_p, opt, _ = adamw_update(opt_cfg, [p.detach() for p in params],
                                         grads, opt)
            with torch.no_grad():
                for p, q in zip(params, new_p):
                    p.copy_(q)
    return module, float(loss.detach())


def _log_targets(requests) -> np.ndarray:
    return np.log1p([float(r.output_len) for r in requests]).astype(np.float32)


# ---------------------------------------------------------------------------
# The paper's MoE-style predictor
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PredictorScale:
    feature_dim: int = 512
    expert_hidden: tuple = (256, 128, 64)
    router_hidden: int = 128


PAPER_SCALE = PredictorScale(2048, (1408, 1024, 512), 512)   # ~44.7M params
FAST_SCALE = PredictorScale(512, (256, 128, 64), 128)        # CI-friendly


class MoEPredictor:
    name = "moe"

    def __init__(self, num_experts: int = 9,
                 scale: PredictorScale = FAST_SCALE, seed: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        self.K = num_experts
        self.scale = scale
        self.vec = TfIdfVectorizer(dim=scale.feature_dim)
        self.params: Optional[nn.Module] = None
        self._seed = seed

    def _features(self, prompts, input_lens, generated=None) -> torch.Tensor:
        return torch.as_tensor(featurize(self.vec, prompts, input_lens,
                                         generated), device=self.device)

    # -- two-phase training (paper Sec. 3.2) --------------------------------

    def fit(self, requests, *, epochs: int = 60, batch: int = 256,
            lr: float = 3e-4):
        prompts = [r.prompt for r in requests]
        self.vec.fit(prompts)
        x_np = featurize(self.vec, prompts, [r.input_len for r in requests])
        y_np = _log_targets(requests)
        x = torch.as_tensor(x_np, device=self.device)
        y = torch.as_tensor(y_np, device=self.device)
        n, F = x_np.shape
        half = n // 2
        g = torch.Generator().manual_seed(self._seed)
        moe = MoE(F, self.scale.router_hidden, self.scale.expert_hidden,
                  self.K, g).to(self.device)

        # Phase 1: tier partition of the first half, one expert per subset.
        t = int(round(self.K ** 0.5))
        xin = x_np[:half, -2] * 2048.0                    # input length feat
        yout = y_np[:half]
        in_edges = np.quantile(xin, np.linspace(0, 1, t + 1)[1:-1])
        out_edges = np.quantile(yout, np.linspace(0, 1, t + 1)[1:-1])
        tier = (np.digitize(xin, in_edges) * t
                + np.digitize(yout, out_edges))           # [half] in [0,K)

        def expert_loss(ep, xb, yb):
            return torch.mean((ep(xb)[:, 0] - yb) ** 2)

        for k in range(self.K):
            idx = np.nonzero(tier == k)[0]
            if len(idx) < 8:                              # degenerate tier
                idx = np.arange(half)
            sel = torch.as_tensor(idx, device=self.device)
            _fit(expert_loss, moe.experts[k], (x[sel], y[sel]),
                 epochs=epochs, batch=batch, lr=lr, seed=self._seed + k)

        # Phase 2: freeze experts, train the router on the second half.
        def router_loss(m, xb, yb):
            return torch.mean((m(xb)[0] - yb) ** 2)

        trainable = {k: 1.0 if k.startswith("router.") else 0.0
                     for k, _ in moe.named_parameters()}
        _fit(router_loss, moe, (x[half:], y[half:]), epochs=epochs,
             batch=batch, lr=lr, seed=self._seed + 101, trainable=trainable)
        self.params = moe
        return self

    def n_params(self) -> int:
        return sum(p.numel() for p in self.params.parameters())

    def _forward(self, x):
        return self.params(x)[0]

    # -- batched inference ---------------------------------------------------

    @torch.no_grad()
    def predict(self, prompts, input_lens, generated=None) -> np.ndarray:
        logy = self._forward(self._features(prompts, input_lens, generated))
        return np.expm1(logy.cpu().numpy()).clip(1.0, None)

    def predict_requests(self, requests) -> np.ndarray:
        return self.predict([r.prompt for r in requests],
                            [r.input_len for r in requests])


# ---------------------------------------------------------------------------
# Baselines (Fig. 8)
# ---------------------------------------------------------------------------

class SingleMLPPredictor(MoEPredictor):
    """STAR-style single 4-layer MLP [arXiv:2510.13668]."""
    name = "single_mlp"

    def fit(self, requests, *, epochs: int = 60, batch: int = 256,
            lr: float = 3e-4):
        prompts = [r.prompt for r in requests]
        self.vec.fit(prompts)
        x = self._features(prompts, [r.input_len for r in requests])
        y = torch.as_tensor(_log_targets(requests), device=self.device)
        F = x.shape[1]
        edims = (F,) + tuple(self.scale.expert_hidden) + (1,)
        mlp = _MLP(edims, torch.Generator().manual_seed(self._seed))
        mlp = mlp.to(self.device)

        def loss(p, xb, yb):
            return torch.mean((p(xb)[:, 0] - yb) ** 2)

        _fit(loss, mlp, (x, y), epochs=epochs, batch=batch, lr=lr,
             seed=self._seed)
        self.params = mlp
        return self

    def _forward(self, x):
        return self.params(x)[:, 0]


class HistoryPredictor:
    """Past-Future-style history lookup [ASPLOS'25]: running mean of
    recent outputs in the same (family-agnostic) prompt-length bucket."""
    name = "history"

    def __init__(self, n_buckets: int = 16, window: int = 256):
        self.n_buckets = n_buckets
        self.window = window
        self.hist = [[] for _ in range(n_buckets)]
        self.default = 256.0
        self.edges = None

    def fit(self, requests, **_):
        lens = np.array([r.input_len for r in requests], np.float32)
        self.edges = np.quantile(lens, np.linspace(0, 1, self.n_buckets + 1)
                                 [1:-1])
        for r in requests:
            self.observe(r.input_len, r.output_len)
        return self

    def _bucket(self, input_len) -> int:
        if self.edges is None:
            # runtime feedback may arrive before any fit(): degrade to a
            # single shared bucket instead of crashing the serving loop
            return 0
        return int(np.digitize(input_len, self.edges))

    def observe(self, input_len: int, output_len: int):
        h = self.hist[self._bucket(input_len)]
        h.append(float(output_len))
        if len(h) > self.window:
            del h[0]

    def predict(self, prompts, input_lens, generated=None) -> np.ndarray:
        out = []
        for il in input_lens:
            h = self.hist[self._bucket(il)]
            out.append(np.mean(h[-self.window:]) if h else self.default)
        return np.asarray(out, np.float32)

    def predict_requests(self, requests) -> np.ndarray:
        return self.predict([r.prompt for r in requests],
                            [r.input_len for r in requests])


class _EncoderLayer(nn.Module):
    def __init__(self, d: int, g: Optional[torch.Generator] = None):
        super().__init__()
        self.wq, self.wk, self.wv = (nn.Linear(d, d, bias=False)
                                     for _ in range(3))
        if g is not None:
            with torch.no_grad():
                for lin in (self.wq, self.wk, self.wv):
                    lin.weight.copy_(_randn(g, d, d).T * d ** -0.5)
        self.ff = _MLP((d, 4 * d, d), g)


class _Encoder(nn.Module):
    """Embedding, ``n_layers`` single-head attention + MLP residual layers
    over the non-pad tokens, mean pooling, and an MLP head."""

    def __init__(self, vocab: int, d: int, n_layers: int,
                 g: Optional[torch.Generator] = None):
        super().__init__()
        self.embed = nn.Parameter(torch.zeros(vocab, d))
        if g is not None:
            with torch.no_grad():
                self.embed.copy_(_randn(g, vocab, d) * 0.02)
        self.head = _MLP((d, d, 1), g)
        self.layers = nn.ModuleList(_EncoderLayer(d, g)
                                    for _ in range(n_layers))

    def forward(self, toks):
        x = self.embed[toks]                     # [N, L, d]
        mask = (toks > 0)[:, None, :]
        for lyr in self.layers:
            q, k, v = lyr.wq(x), lyr.wk(x), lyr.wv(x)
            s = torch.einsum("nld,nmd->nlm", q, k) / x.shape[-1] ** 0.5
            s = torch.where(mask, s, torch.full_like(s, -1e30))
            x = x + torch.einsum("nlm,nmd->nld", torch.softmax(s, -1), v)
            x = x + lyr.ff(x)
        pooled = x.mean(dim=1)
        return self.head(pooled)[:, 0]


class TransformerProxyPredictor:
    """Stand-in for the S^3 DistilBERT predictor [NeurIPS'23]: a 2-layer
    transformer encoder over hashed token ids.  Higher per-call cost than
    the MLP ensemble, mirroring the paper's overhead comparison."""
    name = "llm_proxy"

    def __init__(self, vocab: int = 4096, d: int = 256, n_layers: int = 2,
                 max_len: int = 64, seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.vocab, self.d, self.n_layers, self.max_len = (vocab, d,
                                                           n_layers, max_len)
        self._seed = seed
        self.params: Optional[nn.Module] = None

    def _tokenize(self, prompts) -> np.ndarray:
        out = np.zeros((len(prompts), self.max_len), np.int32)
        for i, p in enumerate(prompts):
            toks = p.lower().split()[: self.max_len]
            out[i, :len(toks)] = [1 + _hash_token(t, self.vocab - 1)
                                  for t in toks]
        return out

    def _tokens(self, prompts) -> torch.Tensor:
        return torch.as_tensor(self._tokenize(prompts).astype(np.int64),
                               device=self.device)

    def _init(self) -> nn.Module:
        g = torch.Generator().manual_seed(self._seed)
        return _Encoder(self.vocab, self.d, self.n_layers, g).to(self.device)

    def fit(self, requests, *, epochs: int = 20, batch: int = 128,
            lr: float = 3e-4):
        toks = self._tokens([r.prompt for r in requests])
        y = torch.as_tensor(_log_targets(requests), device=self.device)
        enc = self._init()

        def loss(p, xb, yb):
            return torch.mean((p(xb) - yb) ** 2)

        _fit(loss, enc, (toks, y), epochs=epochs, batch=batch, lr=lr,
             seed=self._seed)
        self.params = enc
        return self

    @torch.no_grad()
    def predict(self, prompts, input_lens=None, generated=None) -> np.ndarray:
        return np.expm1(self.params(self._tokens(prompts)).cpu().numpy()
                        ).clip(1.0, None)

    def predict_requests(self, requests) -> np.ndarray:
        return self.predict([r.prompt for r in requests], None)


class SessionAwarePredictor:
    """Wrap any base predictor with per-session running statistics.

    Consecutive steps of an agentic session are strongly correlated (same
    task, same agent scaffold), so the wrapper blends the base per-prompt
    prediction with the running mean of the session's recent completed
    step outputs.  Routers detect the extended interface through the
    ``session_aware`` flag and feed completions via ``observe_step``."""
    name = "session"
    session_aware = True

    def __init__(self, base, blend: float = 0.5, window: int = 8):
        self.base = base
        self.blend = blend
        self.window = window
        self.hist: Dict[int, List[float]] = {}

    def fit(self, requests, **kw):
        self.base.fit(requests, **kw)
        return self

    def observe_step(self, session: int, output_len: float):
        h = self.hist.setdefault(int(session), [])
        h.append(float(output_len))
        if len(h) > self.window:
            del h[0]

    def observe(self, input_len: int, output_len: float):
        """Per-completion feedback (the runtime rectification loop fires
        this at request finish): forward to a base predictor that learns
        online, e.g. HistoryPredictor."""
        if hasattr(self.base, "observe"):
            self.base.observe(input_len, output_len)

    def predict(self, prompts, input_lens, generated=None,
                sessions=None) -> np.ndarray:
        p = np.asarray(self.base.predict(prompts, input_lens, generated),
                       np.float32).copy()
        if sessions is None:
            return p
        for i, s in enumerate(sessions):
            h = self.hist.get(int(s)) if s is not None and s >= 0 else None
            if h:
                p[i] = (1 - self.blend) * p[i] + self.blend * np.mean(h)
        return p

    def predict_requests(self, requests) -> np.ndarray:
        return self.predict([r.prompt for r in requests],
                            [r.input_len for r in requests],
                            sessions=[r.session for r in requests])


def evaluate_mae(pred: np.ndarray, truth: np.ndarray) -> float:
    return float(np.mean(np.abs(pred - truth)))


def _sync(predictor) -> None:
    dev = getattr(predictor, "device", None)
    if dev is None and hasattr(predictor, "base"):
        dev = getattr(predictor.base, "device", None)
    if dev is not None:
        synchronize(dev)


def timed_predict(predictor, requests, repeats: int = 3):
    """(predictions, per-request latency in ms) for Fig. 8b.  The device is
    synchronised before each clock read."""
    preds = predictor.predict_requests(requests)      # warmup + result
    _sync(predictor)
    t0 = time.perf_counter()
    for _ in range(repeats):
        predictor.predict_requests(requests)
    _sync(predictor)
    dt = (time.perf_counter() - t0) / repeats
    return preds, dt * 1000.0 / max(len(requests), 1)


# ---------------------------------------------------------------------------
# Weights carried across from the JAX package
# ---------------------------------------------------------------------------

def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _linear_from_jax(lin: nn.Linear, layer: Mapping) -> None:
    """A reference layer ``{"w": [in, out], "b": [out]}`` into ``lin``."""
    lin.weight.copy_(_tensor(layer["w"]).T)
    if "b" in layer:
        lin.bias.copy_(_tensor(layer["b"]))


def _mlp_from_jax(layers: Sequence[Mapping]) -> _MLP:
    dims = ([np.asarray(layers[0]["w"]).shape[0]]
            + [np.asarray(l["w"]).shape[1] for l in layers])
    mlp = _MLP(dims)
    for lin, layer in zip(mlp.layers, layers):
        _linear_from_jax(lin, layer)
    return mlp


@torch.no_grad()
def predictor_params_from_jax(params) -> nn.Module:
    """The port's module holding a JAX predictor's param tree, handed over
    as numpy arrays (``jax.tree.map(np.asarray, params)``), on the CPU:

    * a list of ``{"w": [in, out], "b": [out]}`` layers (``_init_mlp``,
      ``SingleMLPPredictor``) becomes an ``_MLP``; each ``w`` becomes the
      transposed ``nn.Linear.weight``;
    * ``{"router": [...], "experts": [[...], ...]}`` (``MoEPredictor``)
      becomes a ``MoE``: the router list its router MLP, the experts list
      its K expert MLPs, in order;
    * ``{"embed", "head", "layers"}`` (``TransformerProxyPredictor``)
      becomes an ``_Encoder``.

    Move it with ``.to(device)`` and set it as a predictor's ``params``."""
    if isinstance(params, (list, tuple)):
        return _mlp_from_jax(params)
    if "router" in params:
        router = _mlp_from_jax(params["router"])
        experts = [_mlp_from_jax(e) for e in params["experts"]]
        e0 = experts[0]
        moe = MoE(router.layers[0].in_features, router.layers[0].out_features,
                  [lin.out_features for lin in e0.layers[:-1]], len(experts))
        moe.router = router
        moe.experts = nn.ModuleList(experts)
        return moe
    vocab, d = np.asarray(params["embed"]).shape
    enc = _Encoder(vocab, d, len(params["layers"]))
    enc.embed.copy_(_tensor(params["embed"]))
    enc.head = _mlp_from_jax(params["head"])
    for lyr, src in zip(enc.layers, params["layers"]):
        for name in ("wq", "wk", "wv"):
            _linear_from_jax(getattr(lyr, name), {"w": src[name]})
        lyr.ff = _mlp_from_jax(src["ff"])
    return enc
