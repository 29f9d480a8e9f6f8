"""Dry-run cell construction: step functions and fully placed meta inputs
for every (arch x shape x mesh) combination.

Counterpart of ``repro/launch/specs.py``.  Nothing is allocated on any
device: the parameters, optimizer state and cache are meta tensors
(``init_params(..., device="meta")``), placed on the mesh by the sharding
rules as DTensors whose local shards are meta tensors too, and the inputs
likewise; running the step on them in a fake world (``launch/mesh.py``)
traces one rank's work, the counterpart of the reference's ``lower`` and
``compile`` on ``ShapeDtypeStruct``s.  The kernels on the path report
their work from their meta branches.  Train cells run
``make_train_step`` or ``make_grad_accum_step`` on fp32 masters through the
plain training forward, as the reference's; prefill cells run the port's
``prefill`` (B2 and B3 under ``local_map``) and turn its states into the
ring cache; decode cells run ``ring_decode_step`` over the ring cache.
"""
from __future__ import annotations

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.context import ShardCtx
from repro_torch.models.model import (init_cache, init_params, prefill,
                                      ring_decode_step, to_ring_cache)
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import (make_grad_accum_step,
                                             make_train_step)


def _pick_accum(cfg: ModelConfig) -> int:
    """Micro-batch count for train_4k: bounds per-step activation memory
    (global batch and per-optimizer-step FLOPs are unchanged)."""
    n = cfg.param_count()
    if cfg.moe is not None or n > 20e9:
        return 4
    if n > 2e9:
        return 2
    return 1


def make_ctx(mesh) -> ShardCtx:
    data_axes = tuple(a for a in mesh.mesh_dim_names if a != "model")
    return ShardCtx(mesh=mesh, data_axes=data_axes, model_axis="model")


def _logits_spec(cfg: ModelConfig, mesh, batch: int, data_axes):
    b = shd._batch_entry(batch, mesh, data_axes)
    v = ("model" if cfg.vocab_size % shd.axis_size(mesh, "model") == 0
         else None)
    return (b, v)


def _needs_fsdp_serve(cfg: ModelConfig, mesh, hbm_budget_gb: float = 6.0):
    """Whether serve params must be FSDP-sharded beyond TP to fit: the
    reference's rule, its per-chip budget of 6.0 GB kept as the default
    (a budget of the reference's, not the memory of any card)."""
    tp = shd.axis_size(mesh, "model")
    bytes_per_chip = cfg.param_count() * 2 / tp
    return bytes_per_chip > hbm_budget_gb * 1e9


def _meta(shape, dtype, spec, mesh):
    return shd.distribute(torch.empty(shape, dtype=dtype, device="meta"),
                          spec, mesh)


def _placed(t, spec, mesh):
    """``t`` redistributed to ``spec`` (the reference's out_shardings); a
    plain tensor (the same on every rank) placed by it."""
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor):
        return shd.distribute(t, spec, mesh)
    return t.redistribute(mesh, shd.placements(spec, mesh))


def _placed_tree(tree, specs, mesh):
    return shd._map_tree(lambda t, s: _placed(t, s, mesh), tree, specs)


def build_cell(arch: str, shape_name: str, mesh, *,
               param_dtype_serve=torch.bfloat16, ce_chunk: int = 512):
    """Returns (step_fn, kwargs, out_specs, donated names, meta) for one
    dry-run cell: ``step_fn(**kwargs)`` runs the cell's step on meta
    DTensors placed on ``mesh``; ``out_specs`` are the specs of its
    outputs (None where the step leaves them as they come); the donated
    arguments are updated in place."""
    cfg = get_config(arch)
    shape: ShapeSpec = SHAPES[shape_name]
    ctx = make_ctx(mesh)
    data_axes = ctx.data_axes
    B, S = shape.global_batch, shape.seq_len
    batch_entry = shd._batch_entry(B, mesh, data_axes)
    n_pre = cfg.n_prefix_embeds
    meta = {"arch": arch, "shape": shape_name, "kind": shape.kind,
            "batch": B, "seq": S,
            "mesh": {a: shd.axis_size(mesh, a) for a in mesh.mesh_dim_names}}

    if shape.kind == "train":
        model = init_params(cfg, dtype=torch.float32, device="meta")
        pspecs = shd.make_param_specs(model, mesh, fsdp=True)
        ospecs = shd.make_opt_specs(pspecs)
        shd.shard_model(model, mesh, pspecs)
        opt_state = {k: {n: _meta(p.shape, torch.float32, pspecs[n], mesh)
                         for n, p in model.named_parameters()}
                     for k in ("m", "v")}
        opt_state["step"] = 0
        accum = _pick_accum(cfg)
        micro = B // accum
        meta["grad_accum"] = accum
        mb_entry = shd._batch_entry(micro, mesh, data_axes)
        text_len = S - n_pre

        def tok(L, dtype=torch.int32):
            if accum == 1:
                return _meta((B, L), dtype, (mb_entry, None), mesh)
            return _meta((accum, micro, L), dtype, (None, mb_entry, None),
                         mesh)

        kwargs = {"model": model, "opt_state": opt_state,
                  "tokens": tok(text_len), "labels": tok(S),
                  "mask": tok(S, torch.float32)}
        if n_pre:
            shp = ((B, n_pre, cfg.d_model) if accum == 1
                   else (accum, micro, n_pre, cfg.d_model))
            spec = ((mb_entry, None, None) if accum == 1
                    else (None, mb_entry, None, None))
            kwargs["prefix_embeds"] = _meta(shp, torch.bfloat16, spec, mesh)
        opt_cfg = AdamWConfig(schedule=("wsd" if cfg.lr_schedule == "wsd"
                                        else "cosine"))
        if accum == 1:
            fn = make_train_step(cfg, opt_cfg, ctx, ce_chunk=ce_chunk)
        else:
            fn = make_grad_accum_step(cfg, opt_cfg, accum, ctx,
                                      ce_chunk=ce_chunk)
        return fn, kwargs, (pspecs, ospecs, None), ("model", "opt_state"), \
            meta

    # serving paths: params in bf16, no optimizer
    model = init_params(cfg, dtype=param_dtype_serve, device="meta")
    serve_fsdp = _needs_fsdp_serve(cfg, mesh)
    shd.shard_model(model, mesh,
                    shd.make_param_specs(model, mesh, fsdp=serve_fsdp))
    meta["serve_fsdp"] = serve_fsdp
    cache_specs = shd.make_cache_specs(cfg, B, S, mesh, data_axes=data_axes)
    logits_spec = _logits_spec(cfg, mesh, B, data_axes)

    if shape.kind == "prefill":
        text_len = S - n_pre
        kwargs = {"model": model,
                  "tokens": _meta((B, text_len), torch.int32,
                                  (batch_entry, None), mesh)}
        if n_pre:
            kwargs["prefix_embeds"] = _meta(
                (B, n_pre, cfg.d_model), param_dtype_serve,
                (batch_entry, None, None), mesh)

        @torch.no_grad()
        def prefill_step(model, tokens, prefix_embeds=None):
            logits, states = prefill(model, tokens, prefix_embeds, ctx)
            cache = to_ring_cache(cfg, states, S, S)
            return (_placed(logits, logits_spec, mesh),
                    _placed_tree(cache, cache_specs, mesh))

        return prefill_step, kwargs, (logits_spec, cache_specs), (), meta

    # decode
    cache = shd.distribute(
        init_cache(cfg, B, S, dtype=param_dtype_serve, device="meta",
                   ring=True), cache_specs, mesh)
    kwargs = {"model": model, "cache": cache,
              "tokens": _meta((B, 1), torch.int32, (batch_entry, None), mesh)}

    @torch.no_grad()
    def serve_step(model, cache, tokens):
        logits, cache = ring_decode_step(model, tokens, cache, ctx)
        return _placed(logits, logits_spec, mesh), cache

    return serve_step, kwargs, (logits_spec, cache_specs), ("cache",), meta


def input_specs(arch: str, shape_name: str, mesh):
    """The placed meta stand-ins for every input of a cell."""
    _, kwargs, _, _, _ = build_cell(arch, shape_name, mesh)
    return kwargs
