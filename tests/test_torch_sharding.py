"""The port's distributed layer against the JAX package's, on the CPU.

* Parameter specs (``make_param_specs``) for every arch on the meshes
  {data 16, model 16}, {pod 2, data 16, model 16} and {data 2, model 2},
  with and without FSDP: each parameter's spec is the reference's leaf
  spec (from ``jax.eval_shape`` shapes on a stand-in mesh, as
  ``tests/test_sharding.py`` builds them) without the stage's repeat axis.
* Cache specs at (128, 32768), (32, 32768) and (1, 524288) for every arch
  on the three meshes; ``input_sharding`` and the ``ShardCtx`` predicates
  over a grid of sizes; the cell grid, ``_pick_accum`` and
  ``_needs_fsdp_serve``.
* ``ring_decode_step`` against the reference's ``decode_step`` on bridged
  fp32 weights, 4 steps after ``prefill`` (and after ``prefill_chunk`` +
  ``ring_convert_cache``): logits within 1e-4, greedy tokens equal.
* The MoE ``local_map`` branch at 1 rank (gloo, a 1 x 1 mesh) against the
  reference's ``shard_map`` branch on a 1 x 1 JAX mesh of ``Auto`` axes
  (the installed jax makes ``Explicit`` ones, under which the reference's
  branch does not run): outputs within 1e-5, aux equal.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import ALL_ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduce_config as jax_reduce  # noqa: E402
from repro.distributed import sharding as JS  # noqa: E402
from repro.distributed.context import ShardCtx as JCtx  # noqa: E402
from repro.launch import specs as JSpecs  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.distributed import sharding as TS  # noqa: E402
from repro_torch.distributed.context import ShardCtx as TCtx  # noqa: E402
from repro_torch.launch import specs as TSpecs  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import (_flat, _to_tensor,  # noqa: E402
                                        from_jax_params, jax_location)

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2": {"data": 2, "model": 2}}
CACHE_SIZES = ((128, 32768), (32, 32768), (1, 524288))
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread per test module: the tier-1 run's workers share the
    host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeMesh:
    """Axis sizes as both packages read them: ``shape[name]`` (JAX) and
    ``size(i)`` over ``mesh_dim_names`` (a torch ``DeviceMesh``)."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.mesh_dim_names = tuple(shape)

    def size(self, i: int) -> int:
        return self.shape[self.mesh_dim_names[i]]


def _np(t):
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


_shapes = {}


def _jax_shapes(arch):
    if arch not in _shapes:
        cfg = jax_get_config(arch)
        _shapes[arch] = jax.eval_shape(
            lambda k: JM.init_params(cfg, k, dtype=jnp.float32),
            jax.random.PRNGKey(0))
    return _shapes[arch]


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_port_has_every_arch():
    assert set(TC.ALL_ARCHS) == set(JAX_ARCHS)


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_param_specs_match_reference(arch, mesh, fsdp):
    m = FakeMesh(MESHES[mesh])
    ref = JS.make_param_specs(_jax_shapes(arch), m, fsdp=fsdp)
    model = TM.init_params(get_config(arch), dtype=torch.float32,
                           device="meta")
    got = TS.make_param_specs(model, m, fsdp=fsdp)
    assert set(got) == {n for n, _ in model.named_parameters()}
    for name, spec in got.items():
        path, r = jax_location(model.cfg, name)
        want = tuple(_leaf(ref, path))
        if r is not None:
            assert want[0] is None
            want = want[1:]
        assert spec == want, (name, spec, want)


@pytest.mark.parametrize("size", CACHE_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_cache_specs_match_reference(arch, size):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    batch, max_len = size
    for shape in MESHES.values():
        m = FakeMesh(shape)
        axes = tuple(a for a in shape if a != "model")
        ref = JS.make_cache_specs(jcfg, batch, max_len, m, data_axes=axes)
        got = TS.make_cache_specs(tcfg, batch, max_len, m, data_axes=axes)
        assert got["pos"] == tuple(ref["pos"])
        i = 0
        for si, stage in enumerate(jcfg.stages):
            for _ in range(stage.repeat):
                for pi in range(len(stage.pattern)):
                    want = jax.tree.map(
                        lambda s: tuple(s)[1:], ref["stages"][si][f"blk{pi}"],
                        is_leaf=lambda x: isinstance(x, P))
                    assert got["layers"][i] == want, (arch, i, shape)
                    i += 1
        assert i == len(got["layers"])


GRID = (1, 2, 3, 4, 8, 12, 16, 32, 48, 64, 96, 128, 256, 257, 512, 4096,
        32768, 524288)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_shard_ctx_predicates_match_reference(mesh):
    shape = MESHES[mesh]
    m = FakeMesh(shape)
    axes = tuple(a for a in shape if a != "model")
    j, t = JCtx(mesh=m, data_axes=axes), TCtx(mesh=m, data_axes=axes)
    assert (t.enabled, t.dp_size, t.tp_size) == (j.enabled, j.dp_size,
                                                 j.tp_size)
    for n in GRID:
        assert t.batch_spec_entry(n) == j.batch_spec_entry(n)
        assert t.model_axis_if_divides(n) == j.model_axis_if_divides(n)
        assert t.seq_entry(n) == j.seq_entry(n)
        for hd in (16, 64, 96, 128, 256):
            assert t.heads_spec(n, hd) == j.heads_spec(n, hd)
    off = TCtx()
    assert not off.enabled and off.tp_size == 1 and off.heads_spec(8, 64) \
        is None


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_input_sharding_matches_reference(mesh):
    shape = MESHES[mesh]
    m = FakeMesh(shape)
    for axes in (("data",), tuple(a for a in shape if a != "model")):
        for batch in GRID:
            for extra in (1, 2, 3):
                assert TS.input_sharding(m, batch, axes, extra) == tuple(
                    JS.input_sharding(m, batch, axes, extra))
                assert TS._seq_entry(batch, m, list(shape)) == \
                    JS._seq_entry(batch, m, list(shape))
    assert TS.make_opt_specs({"a": (None,)}) == {
        "m": {"a": (None,)}, "v": {"a": (None,)}, "step": ()}


def test_cell_grid_matches_reference():
    from repro.configs import (ASSIGNED_ARCHS, LONG_CONTEXT_ARCHS,
                               assigned_cells, shape_applicable)
    assert TC.ASSIGNED_ARCHS == ASSIGNED_ARCHS
    assert TC.LONG_CONTEXT_ARCHS == LONG_CONTEXT_ARCHS
    assert list(TC.assigned_cells()) == list(assigned_cells())
    assert len(list(TC.assigned_cells())) == 36
    assert list(TC.assigned_cells(True)) == list(assigned_cells(True))
    for arch in JAX_ARCHS:
        for shape in TC.SHAPES:
            assert TC.shape_applicable(arch, shape) == \
                shape_applicable(arch, shape)


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_accum_and_serve_fsdp_match_reference(arch):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    assert TSpecs._pick_accum(tcfg) == JSpecs._pick_accum(jcfg)
    for shape in MESHES.values():
        m = FakeMesh(shape)
        assert TSpecs._needs_fsdp_serve(tcfg, m) == \
            JSpecs._needs_fsdp_serve(jcfg, m)
        axes = tuple(a for a in shape if a != "model")
        for batch in (1, 32, 128, 256):
            assert TSpecs._logits_spec(tcfg, m, batch, axes) == tuple(
                JSpecs._logits_spec(jcfg, m, batch, axes))


# ---------------------------------------------------------------------------
# ring decode against the reference's decode_step
# ---------------------------------------------------------------------------

def _bridged(arch):
    jcfg, tcfg = jax_reduce(jax_get_config(arch)), reduce_config(
        get_config(arch))
    params = JM.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                            device="cpu")
    return jcfg, tcfg, params, model


def _decode_both(jcfg, tcfg, params, model, jcache, tcache, jl, tl, steps=4):
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for _ in range(steps):
        nxt = np.asarray(jnp.argmax(jl, axis=-1))
        assert (tl.argmax(-1).numpy() == nxt).all()
        jl, jcache = JM.decode_step(params, jcfg, jcache,
                                    jnp.asarray(nxt[:, None], jnp.int32))
        tl, tcache = TM.ring_decode_step(model, torch.from_numpy(nxt)[:, None]
                                         .long(), tcache)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    assert (tl.argmax(-1).numpy() == np.asarray(jnp.argmax(jl, -1))).all()
    return jcache, tcache


@pytest.mark.parametrize("arch", ["llama3.1-8b", "gemma3-27b",
                                  "deepseek-v2-lite-16b", "jamba-v0.1-52b"])
def test_ring_decode_matches_reference_decode_step(arch):
    jcfg, tcfg, params, model = _bridged(arch)
    toks = np.random.default_rng(3).integers(0, tcfg.vocab_size, (2, 14))
    max_len = 32
    jl, jcache = JM.prefill(params, jcfg, jnp.asarray(toks, jnp.int32),
                            max_len=max_len)
    tl, states = TM.prefill(model, torch.from_numpy(toks))
    tcache = TM.to_ring_cache(tcfg, states, max_len, 14)
    # the ring cache equals the reference's, layer for layer
    flat = [l for l in tcache["layers"]]
    i = 0
    for si, stage in enumerate(jcfg.stages):
        for r in range(stage.repeat):
            for pi in range(len(stage.pattern)):
                ref = jax.tree.map(lambda a: np.asarray(a)[r],
                                   jcache["stages"][si][f"blk{pi}"])
                jax.tree.map(lambda a, b: np.testing.assert_allclose(
                    _np(b), a, **TOL), ref, flat[i])
                i += 1
    # 14 + 4 positions: a window layer's 16-row ring wraps
    _decode_both(jcfg, tcfg, params, model, jcache, tcache, jl, tl)


@pytest.mark.parametrize("arch", ["llama3.1-8b", "gemma3-27b"])
def test_ring_convert_cache_matches_reference(arch):
    jcfg, tcfg, params, model = _bridged(arch)
    toks = np.random.default_rng(5).integers(0, tcfg.vocab_size, (1, 18))
    max_len = 24
    jcache = JM.init_cache(jcfg, 1, max_len, dtype=jnp.float32, ring=False)
    tcache = TM.init_cache(tcfg, 1, max_len, dtype=torch.float32,
                           device="cpu")
    for s in (0, 6, 12):
        jl, jcache = JM.prefill_chunk(params, jcfg, jcache,
                                      jnp.asarray(toks[:, s:s + 6], jnp.int32))
        tl, tcache = TM.prefill_chunk(model, tcache,
                                      torch.from_numpy(toks[:, s:s + 6]))
    jring = JM.ring_convert_cache(jcfg, jcache, max_len, 18)
    tring = TM.ring_convert_cache(tcfg, tcache, max_len, 18)
    assert tring["pos"].tolist() == [18]
    _decode_both(jcfg, tcfg, params, model, jring, tring, jl, tl)


# ---------------------------------------------------------------------------
# the MoE local_map branch at one rank
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_rank():
    from repro_torch.launch import sharded as SH
    import torch.distributed as dist
    SH.start_world(device="cpu")
    yield SH.mesh_ctx(1, 1, device="cpu")
    dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "mixtral-8x22b"])
def test_moe_local_map_matches_reference_shard_map(arch, one_rank):
    from jax.sharding import AxisType
    jcfg = jax_reduce(jax_get_config(arch))
    tcfg = reduce_config(get_config(arch))
    jp = JL.init_moe(jax.random.PRNGKey(2), jcfg, jnp.float32)
    tp = {k: _to_tensor(a, "cpu")
          for k, a in _flat(jax.tree.map(np.asarray, jp)).items()}
    x = np.random.default_rng(4).standard_normal(
        (4, 6, jcfg.d_model)).astype(np.float32)
    jmesh = jax.make_mesh((1, 1), ("data", "model"),
                          axis_types=(AxisType.Auto,) * 2)
    jctx = JCtx(mesh=jmesh, data_axes=("data",))
    jy, jaux = JL.moe_forward(jp, jcfg, jnp.asarray(x), jctx)
    ctx = one_rank
    mesh = ctx.mesh
    placed = {k: TS.distribute(v, (None,) * v.dim(), mesh)
              for k, v in tp.items()}
    tx = TS.distribute(torch.from_numpy(x), ("data", None, None), mesh)
    calls = []
    real = TL._moe_sharded
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TL, "_moe_sharded",
                   lambda *a: calls.append(1) or real(*a))
        ty, taux = TL.moe_forward(placed, tcfg, tx, ctx)
    assert calls == [1]
    np.testing.assert_allclose(_np(ty.full_tensor()), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    assert float(taux.full_tensor()) == pytest.approx(float(jaux), abs=1e-6)
    plain_y, plain_aux = TL.moe_forward(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(_np(ty.full_tensor()), _np(plain_y),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# prefill_chunk under a mesh at one rank
# ---------------------------------------------------------------------------

def _staging_layers(jcfg, jcache):
    """The reference's staging cache as [layers, B, S, KV, hd] (k, v), its
    stages' repeats unrolled in ``layer_list`` order."""
    ks, vs = [], []
    for si, stage in enumerate(jcfg.stages):
        for r in range(stage.repeat):
            for pi in range(len(stage.pattern)):
                blk = jcache["stages"][si][f"blk{pi}"]
                ks.append(np.asarray(blk["k"])[r])
                vs.append(np.asarray(blk["v"])[r])
    return np.stack(ks), np.stack(vs)


@pytest.mark.parametrize("arch", ["llama3.1-8b", "gemma3-27b"])
def test_prefill_chunk_under_a_mesh_matches_reference(arch, one_rank):
    """Three chunks of 6 tokens through ``prefill_chunk(ctx=)`` on a model
    and staging cache placed on a 1 x 1 gloo mesh: each layer writes and
    runs the flash kernel's plain version on its shard under ``local_map``
    (``_chunk_sharded``, where a DTensor written into a plain cache used to
    fail), and the logits and staging rows equal the port's unsharded run
    and the reference's ``prefill_chunk`` under its ctx (an ``Auto``-axes
    mesh) within 1e-5.  A plain staging cache under the ctx raises."""
    from jax.sharding import AxisType
    from repro_torch.launch import sharded as SH
    jcfg, tcfg, params, model = _bridged(arch)
    ctx = one_rank
    jctx = JCtx(mesh=jax.make_mesh((1, 1), ("data", "model"),
                                   axis_types=(AxisType.Auto,) * 2),
                data_axes=("data",))
    toks = np.random.default_rng(7).integers(0, tcfg.vocab_size, (1, 18))
    max_len = 24
    placed = SH.placed_copy(model, ctx)
    plain = TM.init_cache(tcfg, 1, max_len, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="place_staging"):
        TM.prefill_chunk(placed, plain, torch.from_numpy(toks[:, :6]), ctx)
    jcache = JM.init_cache(jcfg, 1, max_len, dtype=jnp.float32, ring=False)
    tcache = TM.init_cache(tcfg, 1, max_len, dtype=torch.float32,
                           device="cpu")
    scache = SH.place_staging(TM.init_cache(tcfg, 1, max_len,
                                            dtype=torch.float32,
                                            device="cpu"), tcfg, ctx)
    calls = []
    real = TL._chunk_sharded
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TL, "_chunk_sharded",
                   lambda *a: calls.append(1) or real(*a))
        for s in (0, 6, 12):
            chunk = toks[:, s:s + 6]
            jl, jcache = JM.prefill_chunk(params, jcfg, jcache,
                                          jnp.asarray(chunk, jnp.int32),
                                          ctx=jctx)
            tl, tcache = TM.prefill_chunk(model, tcache,
                                          torch.from_numpy(chunk))
            sl, scache = TM.prefill_chunk(
                placed, scache, SH.place_batch(torch.from_numpy(chunk), ctx),
                ctx)
            np.testing.assert_allclose(_np(sl.full_tensor()), np.asarray(jl),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(_np(sl.full_tensor()), _np(tl),
                                       rtol=1e-5, atol=1e-5)
    assert len(calls) == 3 * tcfg.num_layers
    assert scache["pos"] == tcache["pos"] == 18
    jk, jv = _staging_layers(jcfg, jcache)
    for name, j in (("k", jk), ("v", jv)):
        rows = _np(scache[name].full_tensor())[:, :, :18]
        np.testing.assert_allclose(rows, _np(tcache[name])[:, :, :18],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(rows, j[:, :, :18], rtol=1e-5, atol=1e-5)
