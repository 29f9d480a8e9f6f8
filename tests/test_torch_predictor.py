"""The port's output-length predictors against the JAX package's.

Featurisation, the history and session predictors are copies and must be
equal.  AdamW steps match to 1e-6; predictions on bridged parameters to
rtol 1e-5; the fit loop from bridged initial parameters follows JAX's step
for step (params allclose to 1e-5 abs); a whole ``fit()`` (whose initial
draw cannot match ``jax.random``'s) lands within 10% of JAX's held-out
MAE.  The tests run single-threaded: the fits are thousands of small
steps."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.cluster.workload import train_corpus as jax_corpus  # noqa: E402
from repro.core import predictor as J  # noqa: E402
from repro.data import features as JF  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro_torch.cluster.workload import train_corpus  # noqa: E402
from repro_torch.core import predictor as T  # noqa: E402
from repro_torch.data import features as TF  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus():
    return train_corpus(n=400, seed=1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_featurize_and_tfidf_equal_jax(corpus):
    prompts = [r.prompt for r in corpus]
    lens = [r.input_len for r in corpus]
    jv, tv = JF.TfIdfVectorizer(dim=64).fit(prompts), TF.TfIdfVectorizer(
        dim=64).fit(prompts)
    np.testing.assert_array_equal(tv.idf, jv.idf)
    gen = list(range(len(prompts)))
    np.testing.assert_array_equal(TF.featurize(tv, prompts, lens, gen),
                                  JF.featurize(jv, prompts, lens, gen))
    np.testing.assert_array_equal(TF.featurize(tv, prompts[:7], lens[:7]),
                                  JF.featurize(jv, prompts[:7], lens[:7]))
    assert TF.feature_dim(tv) == JF.feature_dim(jv) == 66
    for tok in ("select", "ünïcode", "", "x" * 40):
        assert TF._hash_token(tok, 4095) == JF._hash_token(tok, 4095)


@pytest.mark.parametrize("step", [0, 19, 25, 99])
@pytest.mark.parametrize("schedule", ["cosine", "wsd", "const"])
def test_lr_schedule_matches_jax(schedule, step):
    cfg = dict(lr=1e-3, warmup_steps=20, total_steps=100, schedule=schedule)
    got = TO.lr_at(TO.AdamWConfig(**cfg), step)
    want = float(JO.lr_at(JO.AdamWConfig(**cfg), jnp.int32(step)))
    assert got == pytest.approx(want, rel=1e-6)


def _opt_case(kind, rng):
    params = {"w": rng.standard_normal((6, 5)).astype(np.float32),
              "frozen": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    grads = {k: 0.1 * rng.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
    if kind == "clipped":                      # global norm far above 1
        grads = {k: 50.0 * g for k, g in grads.items()}
    if kind == "masked":                       # a frozen matrix: zero grad
        grads["frozen"] = np.zeros_like(grads["frozen"])
    return params, grads


@pytest.mark.parametrize("kind", ["plain", "clipped", "masked"])
def test_adamw_steps_match_jax(kind):
    """Three steps in a row (bias correction and warm-up move each one);
    each step's params, moments and grad norm agree to 1e-6."""
    rng = np.random.default_rng(3)
    params, grads = _opt_case(kind, rng)
    cfg = dict(lr=1e-2, weight_decay=0.1, warmup_steps=2, total_steps=10)
    jcfg, tcfg = JO.AdamWConfig(**cfg), TO.AdamWConfig(**cfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.tensor(v) for k, v in params.items()}
    jo, to = JO.init_opt_state(jp), TO.init_opt_state(tp)
    for _ in range(3):
        jp, jo, jm = JO.adamw_update(jcfg, jp, {k: jnp.asarray(g) for k, g
                                                in grads.items()}, jo)
        tp, to, tm = TO.adamw_update(tcfg, tp, {k: torch.tensor(g) for k, g
                                                in grads.items()}, to)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=1e-6, rtol=0)
            np.testing.assert_allclose(to["m"][k].numpy(),
                                       np.asarray(jo["m"][k]), atol=1e-6)
            np.testing.assert_allclose(to["v"][k].numpy(),
                                       np.asarray(jo["v"][k]), atol=1e-6)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
    assert to["step"] == int(jo["step"]) == 3
    if kind == "masked":
        # a zero-gradient matrix still decays by lr * wd * p each step
        want = params["frozen"].copy()
        for s in range(3):
            want = want - TO.lr_at(tcfg, s) * 0.1 * want
        np.testing.assert_allclose(tp["frozen"].numpy(), want, rtol=1e-6)
        assert np.abs(tp["frozen"].numpy()).sum() < np.abs(
            params["frozen"]).sum()


def test_adamw_takes_a_list():
    p = [torch.ones(2, 2), torch.ones(3)]
    new, st, _ = TO.adamw_update(TO.AdamWConfig(), p, [torch.ones(2, 2),
                                                       torch.ones(3)],
                                 TO.init_opt_state(p))
    assert isinstance(new, list) and st["step"] == 1
    assert torch.equal(p[0], torch.ones(2, 2))          # inputs untouched


def _jax_moe_params(F, K, seed=0):
    key = jax.random.PRNGKey(seed)
    kr, *ke = jax.random.split(key, 1 + K)
    params = {"router": J._init_mlp(kr, (F, 16, K)),
              "experts": [J._init_mlp(k, (F, 24, 12, 8, 1)) for k in ke]}
    for e in params["experts"]:                 # outputs in the unclipped
        e[-1]["b"] = e[-1]["b"] + 4.0           # range: about e^4 tokens
    return params


def _bridged_pair(kind, corpus):
    prompts = [r.prompt for r in corpus]
    scale = dict(feature_dim=62, expert_hidden=(24, 12, 8), router_hidden=16)
    if kind == "llm_proxy":
        jp = J.TransformerProxyPredictor(vocab=512, d=32, n_layers=2,
                                         max_len=16, seed=4)
        jp.params = jp._init()
        jp.params["head"][-1]["b"] = jp.params["head"][-1]["b"] + 4.0
        jp._predict_jit = jax.jit(jp._apply)
        tp = T.TransformerProxyPredictor(vocab=512, d=32, n_layers=2,
                                         max_len=16, device="cpu")
    else:
        cls = "MoEPredictor" if kind == "moe" else "SingleMLPPredictor"
        jp = getattr(J, cls)(num_experts=3,
                             scale=J.PredictorScale(**scale))
        tp = getattr(T, cls)(num_experts=3, scale=T.PredictorScale(**scale),
                             device="cpu")
        jp.vec.fit(prompts)
        tp.vec = TF.TfIdfVectorizer(dim=62, idf=jp.vec.idf.copy())
        if kind == "moe":
            jp.params = _jax_moe_params(64, 3)
            jp._predict_jit = jax.jit(lambda p, xb: J._moe_apply(p, xb)[0])
        else:
            jp.params = _jax_moe_params(64, 1)["experts"][0]
            jp._predict_jit = jax.jit(
                lambda p, xb: J._apply_mlp(p, xb)[:, 0])
    tp.params = T.predictor_params_from_jax(_np(jp.params))
    return jp, tp


@pytest.mark.parametrize("kind", ["moe", "single_mlp", "llm_proxy"])
def test_bridged_predictions_match_jax(kind, corpus):
    jp, tp = _bridged_pair(kind, corpus)
    reqs = corpus[:50]
    want = jp.predict_requests(reqs)
    got = tp.predict_requests(reqs)
    assert got.dtype == want.dtype == np.float32
    assert (want > 1.0).mean() > 0.9            # not just the clip floor
    np.testing.assert_allclose(got, want, rtol=1e-5)
    if kind != "llm_proxy":                     # mid-request re-prediction
        prompts = [r.prompt for r in reqs]
        lens = [r.input_len for r in reqs]
        gen = [3 * i for i in range(len(reqs))]
        np.testing.assert_allclose(tp.predict(prompts, lens, gen),
                                   jp.predict(prompts, lens, gen), rtol=1e-5)
    assert sum(p.numel() for p in tp.params.parameters()) == sum(
        a.size for a in jax.tree.leaves(jp.params))


def test_bridge_maps_router_and_experts_in_order():
    params = _np(_jax_moe_params(10, 3))
    moe = T.predictor_params_from_jax(params)
    assert isinstance(moe, T.MoE) and len(moe.experts) == 3
    np.testing.assert_array_equal(moe.router.layers[1].weight.detach().numpy(),
                                  params["router"][1]["w"].T)
    for k in range(3):
        np.testing.assert_array_equal(
            moe.experts[k].layers[0].weight.detach().numpy(),
            params["experts"][k][0]["w"].T)
        np.testing.assert_array_equal(
            moe.experts[k].layers[3].bias.detach().numpy(),
            params["experts"][k][3]["b"])


@pytest.mark.parametrize("phase", ["expert", "router_frozen_experts"])
def test_fit_loop_from_bridged_params_follows_jax(phase):
    """``_fit`` from bridged initial parameters, same seed and shuffles:
    every parameter ends within 1e-5 (abs) of JAX's.  In the router phase
    the experts' gradients are masked to zero; they still decay, by
    prod(1 - lr_t * wd), as in the reference."""
    rng = np.random.default_rng(0)
    F, K, n = 34, 4, 200
    x = rng.standard_normal((n, F)).astype(np.float32)
    y = (rng.standard_normal(n) + 3).astype(np.float32)
    params = _jax_moe_params(F, K, seed=2)
    kw = dict(epochs=6, batch=32, lr=1e-2, seed=5)
    if phase == "expert":
        jparams = params["experts"][1]
        jp, jl = J._fit(lambda p, xb, yb: jnp.mean(
            (J._apply_mlp(p, xb)[:, 0] - yb) ** 2), jparams,
            (jnp.asarray(x), jnp.asarray(y)), **kw)
        mod = T.predictor_params_from_jax(_np(jparams))
        _, tl = T._fit(lambda m, xb, yb: torch.mean((m(xb)[:, 0] - yb) ** 2),
                       mod, (torch.tensor(x), torch.tensor(y)), **kw)
    else:
        trainable = {"router": jax.tree.map(lambda _: 1.0, params["router"]),
                     "experts": jax.tree.map(lambda _: 0.0,
                                             params["experts"])}
        jp, jl = J._fit(lambda p, xb, yb: jnp.mean(
            (J._moe_apply(p, xb)[0] - yb) ** 2), params,
            (jnp.asarray(x), jnp.asarray(y)), trainable=trainable, **kw)
        mod = T.predictor_params_from_jax(_np(params))
        tr = {k: 1.0 if k.startswith("router.") else 0.0
              for k, _ in mod.named_parameters()}
        _, tl = T._fit(lambda m, xb, yb: torch.mean((m(xb)[0] - yb) ** 2),
                       mod, (torch.tensor(x), torch.tensor(y)),
                       trainable=tr, **kw)
        steps = kw["epochs"] * -(-n // kw["batch"])
        cfg = TO.AdamWConfig(lr=kw["lr"], weight_decay=0.01, warmup_steps=20,
                             total_steps=kw["epochs"] * (n // kw["batch"]))
        shrink = np.prod([1 - TO.lr_at(cfg, s) * 0.01 for s in range(steps)])
        w0 = np.asarray(params["experts"][2][1]["w"]).T
        np.testing.assert_allclose(
            mod.experts[2].layers[1].weight.detach().numpy(), w0 * shrink,
            rtol=1e-5)
        assert shrink < 0.999
    assert tl == pytest.approx(jl, rel=1e-5)
    back = T.predictor_params_from_jax(_np(jp))
    for (name, a), (_, b) in zip(mod.named_parameters(),
                                 back.named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-5, rtol=0, err_msg=name)


def test_fit_heldout_mae_within_margin_of_jax(corpus):
    """Both packages fit ``MoEPredictor`` from their own initial draws on the
    same 400 requests (K=4, feature dim 256, 40 epochs of batch 16, where
    the fit converges); held-out MAE on 200 other requests agrees within
    10% (seeds 0-2 gave 105.9-107.5 for JAX, 106.7-109.0 for the port)."""
    test = train_corpus(n=200, seed=9)
    truth = np.array([r.output_len for r in test], np.float32)
    scale = dict(feature_dim=256, expert_hidden=(128, 64, 32),
                 router_hidden=64)
    kw = dict(epochs=40, batch=16, lr=1e-3)
    jp = J.MoEPredictor(num_experts=4, scale=J.PredictorScale(**scale)
                        ).fit(jax_corpus(n=400, seed=1), **kw)
    tp = T.MoEPredictor(num_experts=4, scale=T.PredictorScale(**scale),
                        device="cpu").fit(corpus, **kw)
    j_mae = J.evaluate_mae(jp.predict_requests(test), truth)
    t_mae = T.evaluate_mae(tp.predict_requests(test), truth)
    assert abs(t_mae - j_mae) <= 0.10 * j_mae, (t_mae, j_mae)
    assert t_mae < 0.6 * truth.mean()                  # it learned something
    assert tp.n_params() == J.MoEPredictor.n_params(jp)


def test_history_and_session_predictors_equal_jax(corpus):
    jh, th = J.HistoryPredictor().fit(corpus), T.HistoryPredictor().fit(corpus)
    test = train_corpus(n=60, seed=9)
    np.testing.assert_array_equal(th.predict_requests(test),
                                  jh.predict_requests(test))
    js, ts = J.SessionAwarePredictor(jh), T.SessionAwarePredictor(th)
    for i, r in enumerate(test[:30]):
        for s in (js, ts):
            s.observe_step(i % 4, r.output_len)
            s.observe(r.input_len, r.output_len)
    prompts = [r.prompt for r in test]
    lens = [r.input_len for r in test]
    sessions = [i % 6 - 1 for i in range(len(test))]
    np.testing.assert_array_equal(
        ts.predict(prompts, lens, sessions=sessions),
        js.predict(prompts, lens, sessions=sessions))
    cold = T.HistoryPredictor()
    cold.observe(10, 7)                              # before any fit
    assert cold.predict(["a"], [10]).tolist() == [7.0]
    assert T.evaluate_mae(np.ones(3), np.zeros(3)) == J.evaluate_mae(
        np.ones(3), np.zeros(3))


def test_timed_predict_reports_per_request_ms(corpus):
    preds, ms = T.timed_predict(T.HistoryPredictor().fit(corpus), corpus[:20])
    assert preds.shape == (20,) and ms >= 0.0
