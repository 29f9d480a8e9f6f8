"""The port's dry run (``launch/specs.py``, ``launch/dryrun.py``) and its op
counter (``launch/op_cost.py``), on the CPU in a fake world.

* Argument bytes: for every one of the 36 cells, the bytes one rank holds
  of ``build_cell``'s inputs on a fake 16 x 16 world equal the sum over
  the reference's specs and ``jax.eval_shape`` shapes (its ``build_cell``
  logic on a stand-in mesh; the optimizer's step counter, a 4-byte int32
  there and a Python int here, left out).
* Hand counts on a fake 2 x 2 world: a column- then row-parallel MLP does
  a quarter of the global flops on each rank and one all-reduce of twice
  its result's bytes; an FSDP weight is all-gathered once, at its full
  size; a flash call under ``local_map`` on meta reports the kernel's own
  count for the rank's shard.
* One cell end to end: ``run_cell``'s record has the reference's keys.
* Importing ``repro_torch.launch.dryrun`` changes no environment variable.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import assigned_cells  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.distributed import sharding as JS  # noqa: E402
from repro.launch import specs as JSpecs  # noqa: E402
from repro.models import init_cache, init_params  # noqa: E402
from repro_torch.launch import mesh as TMesh  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
STAND_IN = SimpleNamespace(shape={"data": 16, "model": 16})
_DT = {"float32": 4, "bfloat16": 2, "int32": 4}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _local(shape, nbytes, spec) -> int:
    n = nbytes
    for d, e in zip(shape, tuple(spec) + (None,) * len(shape)):
        k = 1
        for a in (e if isinstance(e, tuple) else (e,) if e else ()):
            k *= STAND_IN.shape[a]
        assert d % k == 0
        n *= d // k
    return n


def _tree_bytes(shapes, specs) -> int:
    leaves = jax.tree.leaves(shapes)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_leaves)
    return sum(_local(s.shape, _DT[str(s.dtype)], p)
               for s, p in zip(leaves, spec_leaves))


def _reference_arg_bytes(arch, shape_name) -> int:
    """The reference's ``build_cell`` inputs, bytes of one rank."""
    cfg = jax_get_config(arch)
    shape = JSHAPES[shape_name]
    B, S, n_pre = shape.global_batch, shape.seq_len, cfg.n_prefix_embeds
    axes = ("data",)
    be = JS._batch_entry(B, STAND_IN, axes)
    if shape.kind == "train":
        ps = jax.eval_shape(lambda k: init_params(cfg, k, dtype=jnp.float32),
                            jax.random.PRNGKey(0))
        n = 3 * _tree_bytes(ps, JS.make_param_specs(ps, STAND_IN, fsdp=True))
        accum = JSpecs._pick_accum(cfg)
        mb = JS._batch_entry(B // accum, STAND_IN, axes)
        lead = ((B,), (mb,)) if accum == 1 else ((accum, B // accum),
                                                 (None, mb))
        for L, nb in ((S - n_pre, 4), (S, 4), (S, 4)):
            n += _local(lead[0] + (L,), nb, lead[1] + (None,))
        if n_pre:
            n += _local(lead[0] + (n_pre, cfg.d_model), 2,
                        lead[1] + (None, None))
        return n
    ps = jax.eval_shape(lambda k: init_params(cfg, k, dtype=jnp.bfloat16),
                        jax.random.PRNGKey(0))
    fsdp = JSpecs._needs_fsdp_serve(cfg, STAND_IN)
    n = _tree_bytes(ps, JS.make_param_specs(ps, STAND_IN, fsdp=fsdp))
    if shape.kind == "prefill":
        n += _local((B, S - n_pre), 4, (be, None))
        if n_pre:
            n += _local((B, n_pre, cfg.d_model), 2, (be, None, None))
        return n
    cache = jax.eval_shape(lambda: init_cache(cfg, B, S, dtype=jnp.bfloat16))
    n += _tree_bytes(cache, JS.make_cache_specs(cfg, B, S, STAND_IN,
                                                data_axes=axes))
    return n + _local((B, 1), 4, (be, None))


@pytest.mark.parametrize("arch,shape", list(assigned_cells()))
def test_argument_bytes_match_reference(arch, shape):
    from repro_torch.launch.dryrun import local_bytes
    from repro_torch.launch.specs import build_cell
    TMesh.fake_world(256)
    mesh = TMesh.make_production_mesh()
    _, kwargs, _, _, meta = build_cell(arch, shape, mesh)
    assert meta["mesh"] == {"data": 16, "model": 16}
    assert local_bytes(kwargs) == _reference_arg_bytes(arch, shape)


def _small_world():
    TMesh.fake_world(4)
    return TMesh.make_local_mesh(2, 2)


def test_op_count_tensor_parallel_mlp():
    from repro_torch.distributed.sharding import distribute
    from repro_torch.launch.op_cost import OpCounter
    mesh = _small_world()
    x = distribute(torch.empty(64, 256, device="meta"), ("data", None), mesh)
    w1 = distribute(torch.empty(256, 1024, device="meta"), (None, "model"),
                    mesh)
    w2 = distribute(torch.empty(1024, 256, device="meta"), ("model", None),
                    mesh)
    with OpCounter() as c:
        y = torch.relu(x @ w1) @ w2
        y.redistribute(mesh, y.placements[:1] + (
            torch.distributed.tensor.Replicate(),))
    cost = c.analyze()
    assert cost["flops_per_device"] == 2 * 64 * 256 * 1024 * 2 / 4
    assert cost["collectives"] == {
        "all-reduce": {"count": 1, "wire_bytes": 2.0 * 32 * 256 * 4}}
    assert cost["collective_wire_bytes_per_device"] == 2.0 * 32 * 256 * 4


def test_op_count_fsdp_weight_gathers_once():
    from torch.distributed.tensor import Replicate
    from repro_torch.distributed.sharding import distribute
    from repro_torch.launch.op_cost import OpCounter
    mesh = _small_world()
    w = distribute(torch.empty(256, 512, device="meta"), ("data", None),
                   mesh)
    assert w.to_local().shape == (128, 512)
    with OpCounter() as c:
        full = w.redistribute(mesh, (Replicate(), Replicate()))
    assert full.to_local().shape == (256, 512)
    assert c.analyze()["collectives"] == {
        "all-gather": {"count": 1, "wire_bytes": 256.0 * 512 * 4}}
    assert c.peak >= 256 * 512 * 4


def test_op_count_flash_under_local_map_is_the_kernels():
    from repro_torch.distributed.sharding import distribute
    from repro_torch.launch.op_cost import OpCounter
    from repro_torch.launch.specs import make_ctx
    from repro_torch.models.layers import _attend_sharded
    mesh = _small_world()
    ctx = make_ctx(mesh)
    B, L, H, KV, hd = 4, 256, 8, 2, 64
    q = distribute(torch.empty(B, L, H, hd, dtype=torch.bfloat16,
                               device="meta"), ("data", None, "model", None),
                   mesh)
    kv = [distribute(torch.empty(B, L, KV, hd, dtype=torch.bfloat16,
                                 device="meta"),
                     ("data", None, "model", None), mesh) for _ in "kv"]
    with OpCounter() as c:
        out = _attend_sharded(q, *kv, None, None, ctx, train=False)
    assert out.shape == (B, L, H * hd)
    flash = c.analyze()["kernels"]["flash_attention"]
    pairs = L * (L + 1) // 2
    assert flash["calls"] == 1
    assert flash["flops"] == 4.0 * (B // 2) * (H // 2) * hd * pairs
    assert flash["bytes"] == 2 * (2 * (B // 2) * L * (H // 2) * hd
                                  + 2 * (B // 2) * L * (KV // 2) * hd)


def test_run_cell_writes_the_reference_record(tmp_path, monkeypatch):
    from repro_torch.launch import dryrun
    monkeypatch.setattr(dryrun, "RESULTS", tmp_path)
    rec = dryrun.run_cell("deepseek-v2-lite-16b", "decode_32k", False)
    saved = json.loads(Path(rec["saved_to"]).read_text())
    assert set(saved) >= {"arch", "shape", "kind", "batch", "seq", "mesh",
                          "multi_pod", "n_devices", "trace_s",
                          "flops_per_device", "bytes_accessed_per_device",
                          "memory", "collectives",
                          "collective_wire_bytes_per_device", "serve_fsdp"}
    assert set(saved["memory"]) == {"argument_bytes", "output_bytes",
                                    "temp_bytes", "peak_bytes"}
    assert saved["n_devices"] == 256 and saved["flops_per_device"] > 0
    assert math.isfinite(saved["collective_wire_bytes_per_device"])
    assert "all-reduce" in saved["collectives"]     # the MoE down-projection
    assert "SKIP" not in dryrun._summary_line(rec)


def test_importing_dryrun_sets_no_environment_variable():
    code = ("import os, json; before = dict(os.environ); "
            "import repro_torch.launch.dryrun, repro_torch.launch.specs; "
            "print(json.dumps(dict(os.environ) == before))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.stdout.strip() == "true"
