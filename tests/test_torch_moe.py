"""The port's MoE FFN against the JAX package's on the same weights: the
sort-based capacity dispatch (``_moe_local``) and ``moe_forward``'s plain
branch, drop for drop.  fp32: outputs within 1e-5 and the Switch aux loss
within 1e-6 of JAX's, (a) at the reduced size, which never drops, (b) with
drops forced (E=8, K=2, cf=0.5, T=64), (c) with shared experts, and (d) a
bf16 tree whose router stays fp32: the routing is JAX's, the bf16 expert
products within 2e-2 of the output's largest magnitude."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduce_config as jax_reduce  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.convert import _flat, _to_tensor  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_REL = 2e-2


def _np(t):
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _cfgs(arch, **moe):
    """The reduced config of ``arch`` in both packages, its MoE fields
    replaced by ``moe``."""
    j, t = jax_reduce(jax_get_config(arch)), reduce_config(get_config(arch))
    return (dataclasses.replace(j, moe=dataclasses.replace(j.moe, **moe)),
            dataclasses.replace(t, moe=dataclasses.replace(t.moe, **moe)))


# (arch, MoE fields replaced, tokens [B, L], weight dtype)
CASES = {
    "a-reduced-no-drops": ("jamba-v0.1-52b", {}, (2, 13), jnp.float32),
    "b-drops-forced": ("jamba-v0.1-52b",
                       dict(num_experts=8, top_k=2, capacity_factor=0.5),
                       (1, 64), jnp.float32),
    "c-shared-experts": ("deepseek-v2-lite-16b", {}, (2, 13), jnp.float32),
    "d-bf16-experts-fp32-router": ("deepseek-v2-lite-16b", {}, (2, 13),
                                   jnp.bfloat16),
}


def _layer(jcfg, dtype, seed=0):
    """One MoE layer's weights: the JAX dict and the port's bridged one."""
    jp = JL.init_moe(jax.random.PRNGKey(seed), jcfg, dtype)
    tp = TL.frozen({k: _to_tensor(a, "cpu")
                    for k, a in _flat(jax.tree.map(np.asarray, jp)).items()})
    return jp, tp


def _x(cfg, shape, dtype, seed=1):
    x = np.random.default_rng(seed).standard_normal(
        (*shape, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    return jx, _to_tensor(np.asarray(jx), "cpu")


def _group_sizes(tp, cfg, h):
    """Rows routed to each expert, from the port's router on normed h."""
    probs = torch.softmax(h.float() @ tp["router"], dim=-1)
    top_i = torch.topk(probs, cfg.moe.top_k, dim=-1).indices
    return torch.bincount(top_i.reshape(-1), minlength=cfg.moe.num_experts)


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_forward_matches_jax(case):
    arch, moe, shape, dtype = CASES[case]
    jcfg, tcfg = _cfgs(arch, **moe)
    jp, tp = _layer(jcfg, dtype)
    jx, tx = _x(tcfg, shape, dtype)
    jy, jaux = JL.moe_forward(jp, jcfg, jx)
    ty, taux = TL.moe_forward(tp, tcfg, tx)
    assert ty.shape == tx.shape and ty.dtype == tx.dtype
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    if dtype == jnp.float32:
        np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    else:
        err = np.abs(_np(ty) - _np(jy)).max() / np.abs(_np(jy)).max()
        assert err <= BF16_REL, err
    assert ("shared_w_gate" in tp) == (case == "c-shared-experts"
                                       or case.startswith("d-"))
    T = shape[0] * shape[1]
    C = TL.moe_capacity(T, tcfg.moe.top_k, tcfg.moe.num_experts,
                        tcfg.moe.capacity_factor)
    h = TL.rms_norm(tx.reshape(T, -1), tp["ln"], tcfg.norm_eps)
    dropped = int((_group_sizes(tp, tcfg, h) - C).clamp_min(0).sum())
    assert (dropped > 0) == (case == "b-drops-forced"), dropped


def test_moe_local_drops_match_jax_and_change_the_output():
    """(b) on ``_moe_local`` itself: the dropped rows are JAX's, and the
    same tokens routed without a capacity limit give another output."""
    jcfg, tcfg = _cfgs("jamba-v0.1-52b", num_experts=8, top_k=2,
                       capacity_factor=0.5)
    jp, tp = _layer(jcfg, jnp.float32, seed=4)
    jx, tx = _x(tcfg, (64,), jnp.float32, seed=5)
    jy, jaux = JL._moe_local(jp, jcfg, jx, JL._act(jcfg.act))
    ty, taux = TL._moe_local(tp, tcfg, tx, TL._act(tcfg.act))
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    free = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=8.0))
    full, _ = TL._moe_local(tp, free, tx, TL._act(tcfg.act))
    differ = (full - ty).abs().amax(dim=-1) > 1e-6
    assert 0 < int(differ.sum()) < 64


def test_overflow_keeps_the_first_rows_in_token_order():
    """Every token routed to expert 0 (K=1): the expert keeps tokens
    0..C-1 and the later ones get exactly zero, in both packages."""
    jcfg, tcfg = _cfgs("jamba-v0.1-52b", num_experts=4, top_k=1,
                       capacity_factor=1.0)
    jp, tp = _layer(jcfg, jnp.float32)
    d = tcfg.d_model
    router = np.full((d, 4), -1.0, np.float32)
    router[:, 0] = 1.0
    jp = dict(jp, router=jnp.asarray(router))
    tp["router"] = torch.from_numpy(router)
    x = np.abs(np.random.default_rng(2).standard_normal((40, d))) \
        .astype(np.float32)
    C = TL.moe_capacity(40, 1, 4, 1.0)
    assert C == 16 == JL.moe_capacity(40, 1, 4, 1.0)
    ty, _ = TL._moe_local(tp, tcfg, torch.from_numpy(x), TL._act(tcfg.act))
    jy, _ = JL._moe_local(jp, jcfg, jnp.asarray(x), JL._act(jcfg.act))
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    assert bool((ty[C:] == 0).all()) and bool((ty[:C] != 0).any(dim=-1).all())


@pytest.mark.parametrize("T,K,E,cf", [(8, 6, 64, 2.0), (8, 2, 16, 2.0),
                                      (2048, 6, 64, 2.0), (2048, 2, 16, 2.0),
                                      (64, 2, 8, 0.5), (3, 2, 4, 4.0),
                                      (1, 1, 4, 1.0), (100, 3, 7, 1.25)])
def test_capacity_matches_jax(T, K, E, cf):
    assert TL.moe_capacity(T, K, E, cf) == JL.moe_capacity(T, K, E, cf)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "jamba-v0.1-52b",
                                  "mixtral-8x22b"])
def test_free_decode_rows_cannot_take_a_live_rows_place(arch):
    """Decode routes every slot (8 at the full size).  There C = 16 >= T,
    and each token picks K distinct experts, so nothing drops: whatever
    the free rows hold, the live rows' outputs stay the same."""
    full = get_config(arch).moe
    assert TL.moe_capacity(8, full.top_k, full.num_experts,
                           full.capacity_factor) == 16
    small = dataclasses.replace(full, d_ff_expert=32,
                                d_ff_shared=32 if full.num_shared else 0)
    tcfg = dataclasses.replace(reduce_config(get_config(arch)), moe=small)
    tp = TL.init_moe(tcfg, torch.Generator().manual_seed(0), torch.float32)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((8, 1, tcfg.d_model))
                         .astype(np.float32))
    outs = []
    for seed in range(3):
        x[3:] = torch.from_numpy(np.random.default_rng(10 + seed)
                                 .standard_normal((5, 1, tcfg.d_model))
                                 .astype(np.float32))
        outs.append(TL.moe_forward(tp, tcfg, x)[0][:3])
    assert all(torch.equal(outs[0], o) for o in outs[1:])


def test_router_stays_fp32_with_bf16_experts():
    cfg = reduce_config(get_config("deepseek-v2-lite-16b"))
    p = TL.init_moe(cfg, torch.Generator().manual_seed(0), torch.bfloat16)
    assert p["router"].dtype == torch.float32
    assert {k: v.dtype for k, v in p.items() if k != "router"} == \
        {k: torch.bfloat16 for k in p if k != "router"}
    E, ff = cfg.moe.num_experts, cfg.moe.d_ff_expert
    assert tuple(p["w_gate"].shape) == (E, cfg.d_model, ff)
    assert tuple(p["shared_w_down"].shape) == (cfg.moe.d_ff_shared,
                                               cfg.d_model)
    assert "shared_ln" not in p
    jcfg = jax_reduce(jax_get_config("deepseek-v2-lite-16b"))
    _, tp = _layer(jcfg, jnp.bfloat16)
    assert tp["router"].dtype == torch.float32
    assert tp["w_up"].dtype == torch.bfloat16
