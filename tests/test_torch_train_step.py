"""The port's train step (``training/train_step.py``) against the JAX
package's on bridged fp32 weights, on the CPU: dense GQA (llama3.1-8b),
window layers with a partial mask (gemma3-27b) and the WSD schedule late
in its decay (minicpm-2b); the in-place AdamW step against the functional
one; grad accumulation against the full batch and against JAX's; and the
bf16 step as the reference casts.  Hybrid and MoE configs are in
``test_torch_train_hybrid.py``, which uses this module's helpers, as
``test_torch_checkpoint.py`` does.

fp32 (both packages' ``cast_half`` patched to the identity): loss, nll,
aux loss, grad norm, lr, every updated parameter and the AdamW moments
within 1e-4 relative (atol 1e-6).  bf16: loss within 1e-2 relative, each
leaf's gradient at cosine >= 0.99."""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduce_config as jax_reduce  # noqa: E402
from repro.distributed.context import NULL_CTX  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro.training import train_step as JTS  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.models.convert import (from_jax_params,  # noqa: E402
                                        opt_state_to_jax, to_numpy_tree)
from repro_torch.training import optimizer as TO  # noqa: E402
from repro_torch.training import train_step as TTS  # noqa: E402

# fp32 parity: loss, metrics, updated parameters and AdamW moments
TOL = dict(rtol=1e-4, atol=1e-6)
CE_CHUNK = 16
METRICS = ("loss", "nll", "aux_loss", "grad_norm", "lr")
B, S = 2, 24
# lr 1e-3 with the default 100 warmup steps: 1e-5 at step 0
OPT = dict(lr=1e-3, total_steps=10)
WSD = dict(lr=1e-5, warmup_steps=10, total_steps=100, schedule="wsd")
_jitted = {}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread per test module: the tier-1 run's workers share the
    host's cores, and torch's threads fight each other there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(arch: str, layers_per_stage: int):
    return (jax_reduce(jax_get_config(arch), layers_per_stage=layers_per_stage),
            reduce_config(get_config(arch), layers_per_stage=layers_per_stage))


def bridged(arch: str, layers_per_stage: int, seed: int = 0):
    """(JAX cfg, port cfg, JAX fp32 params, the port's model of them).  The
    leaves that init to zero (norm weights, conv biases) are drawn small
    and non-zero, so that their weight decay (or its absence) shows."""
    jcfg, tcfg = configs(arch, layers_per_stage)
    params = JM.init_params(jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: a if np.any(np.asarray(a)) else jnp.asarray(
            0.1 * rng.standard_normal(a.shape), a.dtype), params)
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                            device="cpu")
    return jcfg, tcfg, params, model


def batch(vocab: int, shape, seed: int, partial_mask: bool = False):
    """(tokens, labels, mask) as numpy, of ``shape``."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, shape).astype(np.int32)
    labels = rng.integers(0, vocab, shape).astype(np.int32)
    mask = (rng.random(shape) > 0.3 if partial_mask
            else np.ones(shape)).astype(np.float32)
    return toks, labels, mask


def identity_cast(monkeypatch):
    """Both packages' ``cast_half`` as the identity: the fp32 parity runs
    the same arithmetic in both (a patch of the tests only)."""
    monkeypatch.setattr(JTS, "cast_half", lambda params, dtype=None: params)
    monkeypatch.setattr(TTS, "cast_half", lambda params, dtype=None: params)


def jax_step(key, jcfg, opt_cfg, accum=None):
    """The JAX package's jitted train step (or grad-accumulation step),
    compiled once per ``key`` in this process."""
    if key not in _jitted:
        fn = (JTS.make_train_step(jcfg, opt_cfg, NULL_CTX, ce_chunk=CE_CHUNK)
              if accum is None else
              JTS.make_grad_accum_step(jcfg, opt_cfg, accum, NULL_CTX,
                                       ce_chunk=CE_CHUNK))
        _jitted[key] = jax.jit(fn)
    return _jitted[key]


def opt_configs(**kw):
    return JO.AdamWConfig(**kw), TO.AdamWConfig(**kw)


def jax_opt(params, step: int = 0):
    opt = JO.init_opt_state(params)
    opt["step"] = jnp.int32(step)
    return opt


def port_opt(model, step: int = 0):
    opt = TO.init_opt_state(dict(model.named_parameters()))
    opt["step"] = step
    return opt


def assert_trees_close(got, want, what: str, **tol):
    """Every leaf of two JAX-layout trees, by path."""
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict((jax.tree_util.keystr(p), a) for p, a in
                  jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_g) == len(flat_w), what
    for path, w in flat_w:
        key = jax.tree_util.keystr(path)
        np.testing.assert_allclose(np.asarray(flat_g[key], np.float64),
                                   np.asarray(w, np.float64),
                                   err_msg=f"{what}{key}", **tol)


def assert_step_matches(model, topt, tm, jparams, jopt, jm, metrics):
    """The port's stepped model, state and metrics against JAX's."""
    for k in metrics:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k,
                                   **TOL)
    assert topt["step"] == int(jopt["step"])
    assert_trees_close(to_numpy_tree(model), jparams, "params", **TOL)
    jo = opt_state_to_jax(model, topt)
    for k in ("m", "v"):
        assert_trees_close(jo[k], jopt[k], k, **TOL)


def grads_tree(model):
    """The gradients in the masters' ``.grad``, in the JAX tree's layout."""
    return to_numpy_tree(model, {n: p.grad for n, p in
                                 model.named_parameters()})


def cosine(a, b) -> float:
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def bf16_grads_match(arch: str, lps: int):
    """Loss and gradients of the bf16 step as the reference casts (no
    patch): loss within 1e-2 relative, each leaf at cosine >= 0.99."""
    jcfg, tcfg, params, model = bridged(arch, lps)
    toks, labels, mask = batch(tcfg.vocab_size, (B, S), seed=5)
    grad_fn = jax.jit(jax.value_and_grad(
        JTS.make_loss_fn(jcfg, NULL_CTX, ce_chunk=CE_CHUNK), has_aux=True))
    (jtotal, _), jgrads = grad_fn(params, jnp.asarray(toks),
                                  jnp.asarray(labels), jnp.asarray(mask))
    TTS.trainable(model)
    total, _ = TTS.make_loss_fn(tcfg, ce_chunk=CE_CHUNK)(
        model, *map(torch.from_numpy, (toks, labels, mask)))
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               rtol=1e-2)
    got = dict((jax.tree_util.keystr(p), a) for p, a in
               jax.tree_util.tree_flatten_with_path(grads_tree(model))[0])
    cos = {}
    for path, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]:
        key = jax.tree_util.keystr(path)
        if np.any(np.asarray(g)):
            cos[key] = cosine(got[key], g)
        else:                                  # nothing reaches the leaf
            assert not np.any(got[key]), key
    assert min(cos.values()) >= 0.99, cos


def _step_both(arch, lps, opt_kw, start, partial):
    jcfg, tcfg, params, model = bridged(arch, lps)
    jopt_cfg, topt_cfg = opt_configs(**opt_kw)
    toks, labels, mask = batch(tcfg.vocab_size, (B, S), seed=1,
                               partial_mask=partial)
    step = jax_step((arch, lps, tuple(sorted(opt_kw.items()))), jcfg,
                    jopt_cfg)
    jp, jo, jm = step(params, jax_opt(params, start), jnp.asarray(toks),
                      jnp.asarray(labels), jnp.asarray(mask))
    before = copy.deepcopy(model)
    topt = port_opt(model, start)
    _, _, tm = TTS.make_train_step(tcfg, topt_cfg, ce_chunk=CE_CHUNK)(
        model, topt, *map(torch.from_numpy, (toks, labels, mask)))
    return (model, topt, tm, jp, jo, jm), before, topt_cfg


@pytest.mark.parametrize("arch,lps,opt_kw,start,partial", [
    ("llama3.1-8b", 2, OPT, 0, False),
    ("gemma3-27b", 1, OPT, 0, True),
    ("minicpm-2b", 2, WSD, 90, False),
], ids=["llama3.1-8b", "gemma3-27b-partial-mask", "minicpm-2b-wsd"])
def test_train_step_matches_jax_fp32(monkeypatch, arch, lps, opt_kw, start,
                                     partial):
    identity_cast(monkeypatch)
    got, _, _ = _step_both(arch, lps, opt_kw, start, partial)
    assert_step_matches(*got, METRICS)
    if opt_kw is WSD:          # past the stable phase: the decayed rate
        assert float(got[2]["lr"]) < 0.5 * opt_kw["lr"]


def test_inplace_step_matches_functional_and_jax(monkeypatch):
    """The trainer's in-place AdamW against ``adamw_update`` on the same
    gradients and decay flags (equal), and both against JAX."""
    identity_cast(monkeypatch)
    (model, topt, tm, jp, jo, jm), before, topt_cfg = _step_both(
        "llama3.1-8b", 2, OPT, 0, False)
    params = dict(before.named_parameters())
    grads = {n: p.grad for n, p in model.named_parameters()}
    decay = TTS.decay_flags(params)
    new_p, new_opt, om = TO.adamw_update(topt_cfg, params, grads,
                                         port_opt(before), decay)
    assert float(om["grad_norm"]) == float(tm["grad_norm"])
    for n, p in model.named_parameters():
        assert torch.equal(p, new_p[n]), n
        assert torch.equal(topt["m"][n], new_opt["m"][n]), n
        assert torch.equal(topt["v"][n], new_opt["v"][n]), n
    assert_trees_close(to_numpy_tree(before, new_p), jp, "params", **TOL)
    assert_trees_close(opt_state_to_jax(before, new_opt)["m"], jo["m"], "m",
                       **TOL)


def test_grad_accum_matches_full_batch():
    """As ``tests/test_training.py:69`` holds JAX's: bf16 as the reference
    casts, two micro-batches of 2 against one batch of 4."""
    _, tcfg, _, model = bridged("llama3.1-8b", 1)
    other = copy.deepcopy(model)
    Bt, St, A = 4, 16, 2
    toks, labels, mask = map(torch.from_numpy,
                             batch(tcfg.vocab_size, (Bt, St), seed=3))
    ocfg = TO.AdamWConfig(lr=1e-3, total_steps=10, grad_clip=1e9)
    _, _, m1 = TTS.make_train_step(tcfg, ocfg, ce_chunk=8)(
        model, port_opt(model), toks, labels, mask)
    _, _, m2 = TTS.make_grad_accum_step(tcfg, ocfg, A, ce_chunk=8)(
        other, port_opt(other), *(t.reshape(A, Bt // A, St)
                                  for t in (toks, labels, mask)))
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-4)
    for (n, a), b in zip(model.named_parameters(), other.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=5e-3, atol=5e-5, err_msg=n)


def test_grad_accum_matches_jax_fp32(monkeypatch):
    identity_cast(monkeypatch)
    jcfg, tcfg, params, model = bridged("llama3.1-8b", 2)
    jopt_cfg, topt_cfg = opt_configs(**OPT)
    A = 2
    toks, labels, mask = (a.reshape(A, B, S) for a in batch(
        tcfg.vocab_size, (A * B, S), seed=4, partial_mask=True))
    step = jax_step(("accum", A), jcfg, jopt_cfg, accum=A)
    jp, jo, jm = step(params, jax_opt(params), jnp.asarray(toks),
                      jnp.asarray(labels), jnp.asarray(mask))
    topt = port_opt(model)
    _, _, tm = TTS.make_grad_accum_step(tcfg, topt_cfg, A,
                                        ce_chunk=CE_CHUNK)(
        model, topt, *map(torch.from_numpy, (toks, labels, mask)))
    assert_step_matches(model, topt, tm, jp, jo, jm,
                        ("loss", "grad_norm", "lr"))


def test_bf16_step_matches_jax_llama():
    bf16_grads_match("llama3.1-8b", 2)
