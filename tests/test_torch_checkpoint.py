"""Checkpoints across the two packages, on the CPU: a file the port writes
restores in the JAX package (parameters, AdamW ``m``/``v`` and ``step`` in
the JAX layout) and a file JAX writes restores in the port; one more train
step from each restored state agrees (fp32, both ``cast_half`` patched to
the identity, 1e-4 relative); retention, ``LATEST`` and the atomic
publish; the async writer's snapshot."""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_train_step as P  # noqa: E402
from test_torch_train_step import (B, METRICS, OPT, S,  # noqa: E402,F401
                                  one_thread)
from repro.training import checkpoint as JC  # noqa: E402
from repro_torch.models.convert import (from_jax_params,  # noqa: E402
                                        opt_state_from_jax, opt_state_to_jax,
                                        to_numpy_tree)
from repro_torch.training import checkpoint as TC  # noqa: E402
from repro_torch.training import train_step as TTS  # noqa: E402


@pytest.fixture(scope="module")
def trained():
    """Reduced llama3.1-8b after one port train step (bf16, as the
    reference casts): non-zero moments, step 1, and a batch for the next."""
    jcfg, tcfg, _, model = P.bridged("llama3.1-8b", 2)
    _, topt_cfg = P.opt_configs(**OPT)
    opt = P.port_opt(model)
    first = map(torch.from_numpy, P.batch(tcfg.vocab_size, (B, S), seed=6))
    TTS.make_train_step(tcfg, topt_cfg, ce_chunk=P.CE_CHUNK)(model, opt,
                                                             *first)
    nxt = P.batch(tcfg.vocab_size, (B, S), seed=7, partial_mask=True)
    return jcfg, tcfg, model, opt, nxt


def _state(model, opt):
    return {"params": to_numpy_tree(model), "opt": opt_state_to_jax(model, opt)}


def _equal_trees(a, b):
    la, lb = jax.tree_util.tree_flatten_with_path(a)[0], \
        jax.tree_util.tree_flatten_with_path(b)[0]
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert np.asarray(x).dtype == np.asarray(y).dtype, path
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=jax.tree_util.keystr(path))


def test_port_checkpoint_restores_in_jax(trained, tmp_path):
    _, _, model, opt, _ = trained
    TC.save_checkpoint(tmp_path, 1, _state(model, opt))
    got = JC.restore_checkpoint(tmp_path)
    _equal_trees(got, _state(model, opt))
    assert got["opt"]["step"].shape == () and \
        got["opt"]["step"].dtype == np.int32 and int(got["opt"]["step"]) == 1


def test_jax_checkpoint_restores_in_the_port(trained, tmp_path):
    _, tcfg, model, opt, _ = trained
    JC.save_checkpoint(tmp_path, 1, jax.tree.map(jnp.asarray,
                                                 _state(model, opt)))
    got = TC.restore_checkpoint(tmp_path)
    restored = from_jax_params(got["params"], tcfg, device="cpu")
    ropt = opt_state_from_jax(got["opt"], restored, device="cpu")
    assert ropt["step"] == opt["step"] == 1
    for (n, a), b in zip(model.named_parameters(), restored.parameters()):
        assert torch.equal(a, b), n
        assert torch.equal(opt["m"][n], ropt["m"][n]), n
        assert torch.equal(opt["v"][n], ropt["v"][n]), n
    # the same leaves as tensors on a device, and into a given structure
    on_dev = TC.restore_checkpoint(tmp_path, 1, device="cpu")
    assert torch.equal(on_dev["params"]["embed"], model.top["embed"])
    into = TC.restore_checkpoint(tmp_path, 1, target_tree=_state(model, opt))
    _equal_trees(into, got)


def test_training_continues_identically_across_packages(trained, tmp_path,
                                                        monkeypatch):
    """Saved by the port and restored by JAX, saved by JAX and restored by
    the port: one more step of each matches (fp32)."""
    P.identity_cast(monkeypatch)
    jcfg, tcfg, model, opt, nxt = trained
    TC.save_checkpoint(tmp_path / "port", 1, _state(model, opt))
    jstate = jax.tree.map(jnp.asarray,
                          JC.restore_checkpoint(tmp_path / "port"))
    jopt_cfg, topt_cfg = P.opt_configs(**OPT)
    jp, jo, jm = P.jax_step(("llama3.1-8b", 2), jcfg, jopt_cfg)(
        jstate["params"], jstate["opt"], *map(jnp.asarray, nxt))
    JC.save_checkpoint(tmp_path / "jax", 1, jstate)
    got = TC.restore_checkpoint(tmp_path / "jax")
    restored = from_jax_params(got["params"], tcfg, device="cpu")
    ropt = opt_state_from_jax(got["opt"], restored, device="cpu")
    _, _, tm = TTS.make_train_step(tcfg, topt_cfg, ce_chunk=P.CE_CHUNK)(
        restored, ropt, *map(torch.from_numpy, nxt))
    assert ropt["step"] == 2
    P.assert_step_matches(restored, ropt, tm, jp, jo, jm, METRICS)


def test_retention_latest_and_atomic_publish(tmp_path):
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "layers": [{"b": np.ones(2, np.float32)}], "step": 0}
    for step in (1, 2, 3, 4, 5):
        TC.save_checkpoint(tmp_path, step, tree)
    assert TC.all_steps(tmp_path) == JC.all_steps(tmp_path) == [3, 4, 5]
    assert TC.latest_step(tmp_path) == 5
    assert (tmp_path / "LATEST").read_text() == "5"
    assert not list(tmp_path.glob(".tmp-*"))
    got = TC.restore_checkpoint(tmp_path)
    assert isinstance(got["layers"], list)
    np.testing.assert_array_equal(got["layers"][0]["b"], tree["layers"][0]["b"])
    with pytest.raises(FileNotFoundError):
        TC.restore_checkpoint(tmp_path / "empty")


def test_async_snapshot_is_a_copy(trained, tmp_path):
    """Tensors and arrays changed in place right after ``save`` (as the
    in-place optimizer changes the masters) leave the file as it was."""
    model, opt = copy.deepcopy(trained[2]), copy.deepcopy(trained[3])
    t = torch.arange(4, dtype=torch.float32)
    a = np.arange(3, dtype=np.float32)
    state = _state(model, opt)
    embed = state["params"]["embed"].copy()
    ck = TC.AsyncCheckpointer()
    ck.save(tmp_path, 9, {"t": t, "a": a, "model": state})
    t.add_(100)
    a += 100
    state["params"]["embed"] += 100      # aliases the CPU model's tensor
    ck.wait()
    got = TC.restore_checkpoint(tmp_path, 9)
    np.testing.assert_array_equal(got["t"], np.arange(4, dtype=np.float32))
    np.testing.assert_array_equal(got["a"], np.arange(3, dtype=np.float32))
    np.testing.assert_array_equal(got["model"]["params"]["embed"], embed)
