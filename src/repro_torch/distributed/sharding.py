"""Parameter / optimizer / cache / input sharding rules.

Counterpart of ``repro/distributed/sharding.py``: ``_RULES_2D``,
``_RULES_3D``, ``_VEC_MODEL``, ``_leaf_spec``, ``make_opt_specs``,
``_batch_entry``, ``_seq_entry`` and ``input_sharding`` (:27-183) in the
same meaning.  Strategy:

* tensor parallel over the ``model`` axis: attention heads (or head_dim
  when the head count doesn't divide), FFN hidden, MoE expert-ff, SSD
  heads, vocab for embed/lm_head;
* FSDP over the ``data`` axis: every param's remaining largest dim is
  additionally sharded when it divides; the ``pod`` axis stays pure DP;
* decode KV caches shard batch over data axes and heads over model,
  falling back to sequence sharding when heads don't divide or batch==1.

A spec is a tuple with one entry per tensor dim (``None``, an axis name,
or a tuple of names), as the reference's ``PartitionSpec`` holds them.
The port keeps a layer's parameters apart (``Model.named_parameters``), so
``make_param_specs`` and ``make_cache_specs`` give each layer's tensor the
reference's spec without the leading ``None`` of the stage's repeat axis.
``placements`` turns a spec into DTensor placements over a ``DeviceMesh``
and ``distribute`` places tensors by their specs (the counterpart of
``as_named`` and ``sds_with_sharding``); ``place_model``, ``placed_copy``,
``place_batch``, ``place_cache`` and ``place_staging`` place a model, a
batch and the caches under a ``ShardCtx`` and ``full`` reads a DTensor
back whole.  A mesh here is a ``DeviceMesh``
with ``mesh_dim_names``, or, for the pure spec functions, anything with a
``shape`` dict of axis sizes.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Optional

from repro_torch.configs.base import ModelConfig

if TYPE_CHECKING:
    from repro_torch.distributed.context import ShardCtx

# (model_dim, fsdp_dim) per leaf name; dims are for the *unstacked* param.
# model_dim/fsdp_dim of None means "never shard that way".
_RULES_2D = {
    # embed / lm_head never take FSDP: their d-dim contraction in the CE
    # loss already uses the data axis for the batch
    "embed": (0, None),     # [V, d]
    "lm_head": (1, None),   # [d, V]
    "prefix_proj": (1, 0),
    "wq": (1, 0), "wk": (1, 0), "wv": (1, 0),
    "wo": (0, 1),
    "w_gate": (1, 0), "w_up": (1, 0),
    "w_down": (0, 1),
    "w_uk": (1, 0), "w_uv": (1, 0),
    "w_dkv": (None, 0),     # small latent down-proj: replicate over model
    "w_z": (1, 0), "w_x": (1, 0), "w_dt": (1, 0),
    "w_B": (None, 0), "w_C": (None, 0),
    "conv_x": (1, None), "conv_B": (None, None), "conv_C": (None, None),
    "out_proj": (0, 1),
    "router": (None, None),
}
_RULES_3D = {                # MoE expert banks [E, d, ff] / [E, ff, d]
    "w_gate": (2, 1), "w_up": (2, 1), "w_down": (1, 2),
}
_VEC_MODEL = {"conv_bx"}     # 1-D vectors sharded over model if divisible


def axis_size(mesh, name: str) -> int:
    """The size of mesh axis ``name``."""
    if hasattr(mesh, "mesh_dim_names"):
        return mesh.size(mesh.mesh_dim_names.index(name))
    return int(mesh.shape[name])


def _leaf_spec(name: str, shape, tp: int, fsdp: int, *,
               model_axis: str, fsdp_axis, stacked: bool,
               do_fsdp: bool) -> tuple:
    core = list(shape[1:]) if stacked else list(shape)
    entries = [None] * len(core)
    if len(core) >= 3 and name in _RULES_3D:
        mdim, fdim = _RULES_3D[name]
    elif len(core) == 2 and name in _RULES_2D:
        mdim, fdim = _RULES_2D[name]
    elif len(core) == 1 and name in _VEC_MODEL:
        mdim, fdim = 0, None
    else:
        mdim, fdim = None, None
    if mdim is not None and core[mdim] % tp == 0 and core[mdim] >= tp:
        entries[mdim] = model_axis
    if (do_fsdp and fdim is not None and fsdp_axis is not None
            and core[fdim] % fsdp == 0 and core[fdim] >= fsdp
            and entries[fdim] is None):
        entries[fdim] = fsdp_axis
    if stacked:
        entries = [None] + entries
    return tuple(entries)


def make_param_specs(model, mesh, *, model_axis: str = "model",
                     fsdp_axis: Optional[str] = "data",
                     fsdp: bool = True) -> Dict[str, tuple]:
    """Spec per ``model.named_parameters()`` name (the same for AdamW's
    ``m`` and ``v``).  The leaf name is the last key of the parameter's
    place in the JAX tree (``convert.jax_location``); a layer's tensor gets
    the reference's spec of its stacked leaf without the repeat axis."""
    from repro_torch.models.convert import jax_location
    tp = axis_size(mesh, model_axis)
    fs = axis_size(mesh, fsdp_axis) if (fsdp and fsdp_axis) else 1
    out = {}
    for name, p in model.named_parameters():
        leaf = jax_location(model.cfg, name)[0][-1]
        out[name] = _leaf_spec(leaf, tuple(p.shape), tp, fs,
                               model_axis=model_axis,
                               fsdp_axis=fsdp_axis if fsdp else None,
                               stacked=False, do_fsdp=fsdp)
    return out


def make_opt_specs(param_specs):
    return {"m": param_specs, "v": param_specs, "step": ()}


# ---------------------------------------------------------------------------
# Cache and input specs
# ---------------------------------------------------------------------------

def _batch_entry(batch: int, mesh, data_axes) -> Optional[object]:
    axes = []
    s = 1
    for a in data_axes:
        n = axis_size(mesh, a)
        if batch % (s * n) == 0:
            axes.append(a)
            s *= n
    if not axes:
        return None
    return tuple(axes) if len(axes) > 1 else axes[0]


def _seq_entry(seq: int, mesh, axes_free) -> Optional[object]:
    """Shard a sequence dim over as many free axes as divide it."""
    use = []
    s = 1
    for a in axes_free:
        n = axis_size(mesh, a)
        if seq % (s * n) == 0 and seq // (s * n) >= 128:
            use.append(a)
            s *= n
    if not use:
        return None
    return tuple(use) if len(use) > 1 else use[0]


def make_cache_specs(cfg: ModelConfig, batch: int, max_len: int, mesh, *,
                     model_axis: str = "model", data_axes=("data",)):
    """Specs matching ``models.model.init_cache(..., ring=True)``: one dict
    per layer in ``cfg.layer_list()`` order, and ``pos``."""
    tp = axis_size(mesh, model_axis)
    b_entry = _batch_entry(batch, mesh, data_axes)
    used = (b_entry if isinstance(b_entry, tuple)
            else (b_entry,) if b_entry else ())
    free_for_seq = [a for a in data_axes if a not in used]

    def attn_spec(S):
        if cfg.num_kv_heads % tp == 0:
            return (b_entry, _seq_entry(S, mesh, free_for_seq), model_axis,
                    None)
        # heads don't divide: flash-decoding style sequence sharding
        seq = _seq_entry(S, mesh, [model_axis] + free_for_seq)
        return (b_entry, seq, None, None)

    def mla_spec(S):
        return (b_entry, _seq_entry(S, mesh, [model_axis] + free_for_seq),
                None)

    layers = []
    for blk in cfg.layer_list():
        if blk.mixer in ("full", "window"):
            S = min(blk.window, max_len) if blk.window else max_len
            layers.append({"k": attn_spec(S), "v": attn_spec(S)})
        elif blk.mixer == "mla":
            layers.append({"ckv": mla_spec(max_len), "kr": mla_spec(max_len)})
        elif blk.mixer == "mamba":
            nh = cfg.ssm.n_heads(cfg.d_model)
            di = cfg.ssm.d_inner(cfg.d_model)
            h_entry = model_axis if nh % tp == 0 else None
            di_entry = model_axis if di % tp == 0 else None
            layers.append({
                "conv": {"x": (b_entry, None, di_entry),
                         "B": (b_entry, None, None),
                         "C": (b_entry, None, None)},
                "ssm": (b_entry, h_entry, None, None)})
        else:
            layers.append({})
    return {"layers": layers, "pos": (None,)}


def input_sharding(mesh, batch: int, data_axes=("data",),
                   extra_dims: int = 1) -> tuple:
    b = _batch_entry(batch, mesh, data_axes)
    return (b,) + (None,) * extra_dims


# ---------------------------------------------------------------------------
# Placement on a DeviceMesh
# ---------------------------------------------------------------------------

def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` over ``mesh``: per mesh dim,
    ``Shard(d)`` where tensor dim d's entry names the axis, else
    ``Replicate()``.  Two mesh axes on one tensor dim give two ``Shard(d)``,
    the outer mesh dim splitting first; the local shapes are the
    reference's; an axis of size 1 gives ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    owner = {}
    for d, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                owner[a] = d
    # an axis of size 1 shards nothing: replicate over it, which leaves
    # DTensor no size-1 shard to carry through reshapes
    return tuple(Shard(owner[a]) if a in owner and mesh.size(i) > 1
                 else Replicate()
                 for i, a in enumerate(mesh.mesh_dim_names))


def _map_tree(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, tree[k], specs[k]) for k in tree}
    if isinstance(tree, (list, tuple)) and not _is_spec(specs):
        return type(tree)(_map_tree(fn, t, s) for t, s in zip(tree, specs))
    return fn(tree, specs)


def _is_spec(s) -> bool:
    return isinstance(s, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in s)


def distribute(tensors, specs, mesh):
    """``tensors`` (a tensor, or dicts and lists of them) placed on ``mesh``
    by ``specs`` of the same structure: DTensors whose local shards this
    rank holds (``distribute_tensor``; on the meta device no data moves)."""
    from torch.distributed.tensor import distribute_tensor

    def place(t, spec):
        if not hasattr(t, "shape"):
            return t
        return distribute_tensor(t, mesh, placements(spec, mesh))
    return _map_tree(place, tensors, specs)


def shard_model(model, mesh, specs: Dict[str, tuple]):
    """Replace each parameter of ``model`` by a DTensor placed by its spec
    (``make_param_specs``), in place; returns the model."""
    from torch import nn
    from torch.distributed.tensor import distribute_tensor
    for name, p in list(model.named_parameters()):
        *path, key = name.split(".")
        owner = model.get_submodule(".".join(path))
        owner[key] = nn.Parameter(
            distribute_tensor(p.data, mesh, placements(specs[name], mesh)),
            requires_grad=p.requires_grad)
    return model


# ---------------------------------------------------------------------------
# Placing a model, a batch and caches under a ShardCtx
# ---------------------------------------------------------------------------

def place_model(model, ctx: ShardCtx, *, fsdp: bool = True):
    """The model's parameters as DTensors placed by their specs, in place;
    returns (model, specs)."""
    specs = make_param_specs(model, ctx.mesh, fsdp=fsdp)
    return shard_model(model, ctx.mesh, specs), specs


def placed_copy(model, ctx: ShardCtx):
    """A model over new parameter dicts holding ``model``'s tensors,
    placed by their specs without FSDP (``place_model``): the engine
    serves tensor-parallel, the weights whole over the data axes, whose
    ranks each decode their own rows; ``model`` itself stays as it is.  Where a
    placement keeps a rank's shard whole (every axis of size 1) the shard
    is the original tensor, not a copy."""
    from repro_torch.models.layers import frozen
    from repro_torch.models.model import Block, Model

    def parts(d):
        return None if d is None else frozen({k: v.data
                                              for k, v in d.items()})
    copy = Model(model.cfg, parts(model.top),
                 [Block(b.spec, parts(b.attn), parts(b.ffn), parts(b.mixer))
                  for b in model.layers])
    return place_model(copy, ctx, fsdp=False)[0]


def place_batch(t, ctx: ShardCtx):
    """A batch-leading tensor, its batch over the data axes."""
    spec = input_sharding(ctx.mesh, t.shape[0], ctx.data_axes, t.dim() - 1)
    return distribute(t, spec, ctx.mesh)


def place_cache(cache: dict, cfg: ModelConfig, ctx: ShardCtx,
                max_len: int) -> dict:
    """A ring cache (``init_cache(..., ring=True)`` layout; plain tensors or
    DTensors) placed by ``make_cache_specs``."""
    from torch.distributed.tensor import DTensor
    specs = make_cache_specs(cfg, cache["pos"].shape[0], max_len, ctx.mesh,
                             data_axes=ctx.data_axes)

    def place(t, spec):
        if isinstance(t, DTensor):
            return t.redistribute(ctx.mesh, placements(spec, ctx.mesh))
        return distribute(t, spec, ctx.mesh)
    return _map_tree(place, cache, specs)


def place_staging(cache: dict, cfg: ModelConfig, ctx: ShardCtx) -> dict:
    """A staging cache (``init_cache(..., ring=False)``: k/v [layers, B,
    max_len, KV, hd]) placed as the chunk step writes it under ``ctx``
    (``layers._chunk_sharded``): the batch over the data axes, the KV
    heads over the model axis where they and the query heads divide it
    (``layers.head_axes``), else whole on every rank; ``pos`` stays a
    number."""
    from repro_torch.models.layers import head_axes
    b = ctx.batch_spec_entry(cache["k"].shape[1])
    spec = (None, b, None, head_axes(cfg.num_heads, cfg.num_kv_heads, ctx)[1],
            None)
    return {"k": distribute(cache["k"], spec, ctx.mesh),
            "v": distribute(cache["v"], spec, ctx.mesh),
            "pos": cache["pos"]}


def full(t):
    """A DTensor gathered whole on every rank; any other tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t
