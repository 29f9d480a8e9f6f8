"""The pieces of the port's training path against the JAX package's, on
the CPU: chunked cross-entropy, the plain training attention
(``_sdpa_chunked``) and scan (``ssd_chunked``), ``grouped_gemm`` and its
backward, ``cast_half`` over every registered config, ``SyntheticLM``, the
in-place AdamW step against the functional one, and the launcher.  Values
and ``jax.vjp`` gradients on the same numpy inputs; tolerances per test."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_train_step import one_thread  # noqa: E402,F401
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduce_config as jax_reduce  # noqa: E402
from repro.data.lm_data import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.models import grouped_gemm as JG  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssd as JS  # noqa: E402
from repro.training import loss as JLoss  # noqa: E402
from repro.training import train_step as JTS  # noqa: E402
from repro_torch.configs import ALL_ARCHS, get_config, reduce_config  # noqa: E402
from repro_torch.data.lm_data import SyntheticLM  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import ssd as TS  # noqa: E402
from repro_torch.models.convert import jax_location  # noqa: E402
from repro_torch.models.grouped_gemm import grouped_gemm  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402
from repro_torch.training.loss import chunked_cross_entropy  # noqa: E402
from repro_torch.training.train_step import (cast_half,  # noqa: E402
                                               decay_flags)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _port_vjp(fn, inputs, cotangents, n_diff):
    """Outputs of ``fn`` on torch copies of ``inputs``, and the gradients of
    sum(out * cotangent) with respect to the first ``n_diff`` inputs."""
    ts = [torch.from_numpy(np.array(a)) for a in inputs]
    for t in ts[:n_diff]:
        t.requires_grad_(True)
    outs = fn(*ts)
    outs = outs if isinstance(outs, tuple) else (outs,)
    pairs = [(o, torch.from_numpy(np.asarray(c)).to(o.dtype))
             for o, c in zip(outs, cotangents) if o.requires_grad]
    torch.autograd.backward(*map(list, zip(*pairs)))
    return outs, [t.grad for t in ts[:n_diff]]


def _jax_vjp(fn, inputs, cotangents, n_diff):
    outs, vjp = jax.vjp(lambda *d: fn(*d, *inputs[n_diff:]),
                        *map(jnp.asarray, inputs[:n_diff]))
    outs = outs if isinstance(outs, tuple) else (outs,)
    cts = tuple(jnp.asarray(c).astype(o.dtype)
                for o, c in zip(outs, cotangents))
    return outs, vjp(cts if len(cts) > 1 else cts[0])


def test_chunked_ce_matches_jax_and_direct_sum():
    """S=37 over chunks of 8 (padded), a random mask, the vocab padded from
    50 to 64 columns: value and gradients (hidden, w_head), fp32, 1e-5."""
    rng = np.random.default_rng(0)
    B, S, D, V, Vp = 2, 37, 16, 50, 64
    h = rng.standard_normal((B, S, D)).astype(np.float32)
    w = rng.standard_normal((D, Vp)).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.3).astype(np.float32)
    (nll, ntok), grads = _port_vjp(
        lambda h_, w_, lab, m: chunked_cross_entropy(h_, w_, lab, m, chunk=8),
        [h, w, labels, mask], [np.float32(1.0), np.float32(0.0)], 2)
    (jnll, jntok), jgrads = _jax_vjp(
        lambda h_, w_, lab, m: JLoss.chunked_cross_entropy(h_, w_, lab, m,
                                                           chunk=8),
        [h, w, labels, mask], [np.float32(1.0), np.float32(0.0)], 2)
    np.testing.assert_allclose(_np(nll), _np(jnll), rtol=1e-5)
    assert float(ntok) == float(jntok) == mask.sum()
    for a, b in zip(grads, jgrads):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-7)
    logits = h.astype(np.float64) @ w
    lse = np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1)) \
        + logits.max(-1)
    tgt = np.take_along_axis(logits, labels[..., None], -1)[..., 0]
    direct = np.sum((lse - tgt) * mask) / mask.sum()
    np.testing.assert_allclose(_np(nll), direct, rtol=1e-5)


@pytest.mark.parametrize("window", [None, 16])
def test_sdpa_chunked_matches_jax(window):
    """Two 512-row query chunks, GQA 4 over 2, with and without a window:
    value and gradients (q, k, v), fp32, 1e-5 (atol 1e-6)."""
    rng = np.random.default_rng(1)
    L, H, KV, hd = 1024, 4, 2, 16
    q = rng.standard_normal((1, L, H, hd)).astype(np.float32)
    k = rng.standard_normal((1, L, KV, hd)).astype(np.float32)
    v = rng.standard_normal((1, L, KV, hd)).astype(np.float32)
    ct = rng.standard_normal((1, L, H * hd)).astype(np.float32)
    (y,), grads = _port_vjp(
        lambda a, b, c: TL._sdpa_chunked(a, b, c, window, None),
        [q, k, v], [ct], 3)
    (jy,), jgrads = _jax_vjp(
        lambda a, b, c: JL._sdpa_chunked(a, b, c, window, None),
        [q, k, v], [ct], 3)
    np.testing.assert_allclose(_np(y), _np(jy), rtol=1e-5, atol=1e-6)
    for a, b in zip(grads, jgrads):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_ssd_chunked_matches_jax(name, tol):
    """Four chunks of 16, 4 heads over 2 groups, as the model feeds it:
    y, final state and the gradients of x, dt, A, B and C within ``tol``
    of each output's largest magnitude.  In bf16 the intra-chunk weights
    are cast to bf16 before their product with x in both."""
    rng = np.random.default_rng(2)
    Bz, L, H, P, G, N, Q = 2, 64, 4, 8, 2, 8, 16
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[name]
    x = rng.standard_normal((Bz, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bz, L, H)) - 2)
                  ).astype(np.float32)
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((Bz, L, G, N)).astype(np.float32)
    Cm = rng.standard_normal((Bz, L, G, N)).astype(np.float32)
    cts = [rng.standard_normal((Bz, L, H, P)).astype(np.float32),
           rng.standard_normal((Bz, H, P, N)).astype(np.float32)]

    def port(x_, dt_, A_, B_, C_):
        return TS.ssd_chunked(x_.to(tdt), dt_, A_, B_.to(tdt), C_.to(tdt), Q)

    def ref(x_, dt_, A_, B_, C_):
        return JS.ssd_chunked(x_.astype(jdt), dt_, A_, B_.astype(jdt),
                              C_.astype(jdt), Q)

    outs, grads = _port_vjp(port, [x, dt, A, Bm, Cm], cts, 5)
    jouts, jgrads = _jax_vjp(ref, [x, dt, A, Bm, Cm], cts, 5)
    for a, b in list(zip(outs, jouts)) + list(zip(grads, jgrads)):
        b = _np(b)
        assert np.abs(_np(a) - b).max() <= tol * np.abs(b).max()
    # the same bf16 roundings: y within 1e-5 of its largest magnitude,
    # where leaving ``att`` in fp32 would put it 2.8e-3 away
    y, jy = _np(outs[0]), _np(jouts[0])
    assert np.abs(y - jy).max() <= 1e-5 * np.abs(jy).max()


def test_grouped_gemm_matches_jax():
    """Three groups, the middle one empty: forward and VJP, fp32, 1e-5."""
    rng = np.random.default_rng(3)
    lhs = rng.standard_normal((10, 6)).astype(np.float32)
    rhs = rng.standard_normal((3, 6, 5)).astype(np.float32)
    gs = np.array([4, 0, 6], np.int32)
    ct = rng.standard_normal((10, 5)).astype(np.float32)
    (y,), grads = _port_vjp(grouped_gemm, [lhs, rhs, gs], [ct], 2)
    (jy,), jgrads = _jax_vjp(JG.grouped_gemm, [lhs, rhs, gs], [ct], 2)
    np.testing.assert_allclose(_np(y), _np(jy), rtol=1e-5, atol=1e-6)
    for a, b in zip(grads, jgrads):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-6)
    assert not np.any(_np(grads[1])[1])          # the empty group's weights


def _jax_leaves(arch: str, cast: bool):
    """{JAX path: leaf shape and dtype} of reduced ``arch``'s fp32 tree, or
    of its ``cast_half``; and the port's model of the same config."""
    jcfg = jax_reduce(jax_get_config(arch), layers_per_stage=1)
    tcfg = reduce_config(get_config(arch), layers_per_stage=1)

    def tree():
        p = JM.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
        return JTS.cast_half(p) if cast else p

    leaves = {"|".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path): a
              for path, a in jax.tree_util.tree_flatten_with_path(
                  jax.eval_shape(tree))[0]}
    return leaves, init_params(tcfg, seed=0, dtype=torch.float32,
                               device="cpu")


def _path(model, name: str) -> str:
    return "|".join(map(str, jax_location(model.cfg, name)[0]))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cast_half_keeps_the_leaves_jax_keeps(arch):
    """The set of leaves left float32, by JAX path: the routers, A_log, D,
    dt_bias and the top-level vectors; a layer's vectors are cast, as the
    reference's stacked ones are (reduced configs: the same leaves)."""
    leaves, model = _jax_leaves(arch, cast=True)
    want = {k for k, a in leaves.items() if a.dtype == jnp.float32}
    cast = cast_half(dict(model.named_parameters()))
    got = {_path(model, n) for n, a in cast.items()
           if a.dtype == torch.float32}
    assert got == want
    assert all(a.dtype == torch.bfloat16 for n, a in cast.items()
               if _path(model, n) not in want)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_decay_flags_follow_the_jax_tree(arch):
    """AdamW decays a leaf where the JAX leaf has ``ndim >= 2``: every
    layer's leaf, its norm weights included (stacked over the stage's
    repeats), and of the top-level ones the matrices."""
    leaves, model = _jax_leaves(arch, cast=False)
    flags = decay_flags(dict(model.named_parameters()))
    assert {_path(model, n) for n, f in flags.items() if f} == \
        {k for k, a in leaves.items() if a.ndim >= 2}
    assert flags["layers.0.attn.ln" if "attn" in model.layers[0].parts
                 else "layers.0.mixer.ln"]


def test_synthetic_lm_batches_are_byte_equal():
    for seed, step in ((0, 0), (3, 17)):
        got = SyntheticLM(1000, seed=seed).batch(step, 4, 33)
        want = JaxSyntheticLM(1000, seed=seed).batch(step, 4, 33)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_inplace_adamw_equals_functional_over_three_steps():
    """Clipping active (gradient norm ~30 over a clip of 1), one leaf's
    gradient masked to zero (it still decays), a 1-D leaf (no decay), the
    WSD schedule: equal tensors and metrics at every step, and the
    functional update leaves its inputs as they were."""
    g = torch.Generator().manual_seed(4)
    shapes = {"w": (8, 6), "frozen": (4, 4), "bias": (6,)}
    params = {k: torch.randn(s, generator=g) for k, s in shapes.items()}
    inplace = {k: p.clone() for k, p in params.items()}
    frozen0 = params["frozen"].clone()
    cfg = TO.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=4,
                         schedule="wsd", wsd_stable_frac=0.5)
    st_f, st_i = TO.init_opt_state(params), TO.init_opt_state(inplace)
    for _ in range(3):
        grads = {k: 10 * torch.randn(s, generator=g) for k, s in shapes.items()}
        grads["frozen"] = torch.zeros(shapes["frozen"])
        kept = [{k: t.clone() for k, t in d.items()}
                for d in (params, st_f["m"], st_f["v"])]
        step_f = st_f["step"]
        new_p, new_st, mf = TO.adamw_update(cfg, params, grads, st_f)
        for d, k0 in zip((params, st_f["m"], st_f["v"]), kept):
            assert all(torch.equal(d[k], k0[k]) for k in shapes)
        assert st_f["step"] == step_f
        params, st_f = new_p, new_st
        mi = TO.adamw_step_(cfg, inplace, grads, st_i)
        assert mi["lr"] == mf["lr"] and float(mf["grad_norm"]) > 10
        assert torch.equal(mi["grad_norm"], mf["grad_norm"])
        assert st_i["step"] == st_f["step"]
        for k in shapes:
            assert torch.equal(inplace[k], params[k]), k
            assert torch.equal(st_i["m"][k], st_f["m"][k]), k
            assert torch.equal(st_i["v"][k], st_f["v"][k]), k
    # the masked leaf only decayed: shrunk toward zero, sign kept
    assert torch.all(inplace["frozen"].abs() < frozen0.abs())
    assert torch.equal(inplace["frozen"].sign(), frozen0.sign())


ARGS = ["--arch", "llama3.1-8b", "--reduced", "--device", "cpu",
        "--steps", "60", "--ckpt-every", "30"]


@pytest.fixture(scope="module")
def unbroken(tmp_path_factory):
    return launcher.main(ARGS + ["--ckpt-dir",
                                 str(tmp_path_factory.mktemp("unbroken"))])


def test_launcher_drives_the_loss_below_uniform_entropy(unbroken):
    assert len(unbroken) == 60
    assert unbroken[-1] < math.log(512) < unbroken[0] + 1


def test_launcher_resumes_a_crashed_run_exactly(unbroken, tmp_path,
                                                monkeypatch):
    """The run dies fetching step 30's batch, after its step-30 checkpoint;
    started again, it resumes there and gives the unbroken run's losses."""
    real = launcher.SyntheticLM.batch

    def dies_at_30(self, step, *a):
        if step == 30:
            raise KeyboardInterrupt("killed")
        return real(self, step, *a)

    monkeypatch.setattr(launcher.SyntheticLM, "batch", dies_at_30)
    with pytest.raises(KeyboardInterrupt):
        launcher.main(ARGS + ["--ckpt-dir", str(tmp_path)])
    monkeypatch.setattr(launcher.SyntheticLM, "batch", real)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["LATEST",
                                                          "step-30.npz"]
    resumed = launcher.main(ARGS + ["--ckpt-dir", str(tmp_path)])
    assert resumed == unbroken[30:]
