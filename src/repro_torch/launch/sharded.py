"""Helpers that run the model sharded over a real process group: start the
world, build a (data, model) mesh on a device, place the model, a batch,
a ring cache and AdamW's state on it by the sharding rules, and read a
DTensor back whole.

They take ``device="cuda"`` by default (NCCL) and raise without a card;
``device="cpu"`` runs them over gloo.  The steps themselves are the
model's own (``prefill``, ``ring_decode_step``, ``make_train_step``) called
with the ``ShardCtx`` that ``mesh_ctx`` returns.
"""
from __future__ import annotations

import socket

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.context import ShardCtx


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_world(*, device="cuda", rank: int = 0, world_size: int = 1,
                init_method=None) -> None:
    """Join (or start) the default process group: NCCL on CUDA (this rank
    on card ``rank``), gloo on the CPU; at world size 1 over a free
    localhost port unless ``init_method`` says where."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return
    if dev.type == "cuda":
        torch.cuda.set_device(rank)
    if init_method is None:
        init_method = f"tcp://localhost:{free_port()}"
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method, rank=rank,
                            world_size=world_size)


def mesh_ctx(data: int = 1, model: int = 1, *, device="cuda") -> ShardCtx:
    """A ``ShardCtx`` over a (data, model) mesh of the started world."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.specs import make_ctx
    dev = resolve_device(device)
    return make_ctx(make_local_mesh(data, model, device_type=dev.type))


def place_model(model, ctx: ShardCtx, *, fsdp: bool = True):
    """The model's parameters as DTensors placed by their specs, in place;
    returns (model, specs)."""
    specs = shd.make_param_specs(model, ctx.mesh, fsdp=fsdp)
    return shd.shard_model(model, ctx.mesh, specs), specs


def place_batch(t, ctx: ShardCtx):
    """A batch-leading tensor, its batch over the data axes."""
    spec = shd.input_sharding(ctx.mesh, t.shape[0], ctx.data_axes,
                              t.dim() - 1)
    return shd.distribute(t, spec, ctx.mesh)


def place_cache(cache: dict, cfg, ctx: ShardCtx, max_len: int) -> dict:
    """A ring cache (``init_cache(..., ring=True)`` layout; plain tensors or
    DTensors) placed by ``make_cache_specs``."""
    from torch.distributed.tensor import DTensor
    specs = shd.make_cache_specs(cfg, cache["pos"].shape[0], max_len,
                                 ctx.mesh, data_axes=ctx.data_axes)

    def place(t, spec):
        if isinstance(t, DTensor):
            return t.redistribute(ctx.mesh, shd.placements(spec, ctx.mesh))
        return shd.distribute(t, spec, ctx.mesh)
    return shd._map_tree(place, cache, specs)


def full(t):
    """A DTensor gathered whole on every rank; any other tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t
