"""Helpers that run the model sharded over a real process group: start the
world and build a (data, model) mesh on a device.  The placement helpers
(the model, a batch, a ring cache, a staging cache; a DTensor read back
whole) live in ``distributed.sharding`` and are re-exported here.

They take ``device="cuda"`` by default (NCCL) and raise without a card;
``device="cpu"`` runs them over gloo.  The steps themselves are the
model's own (``prefill``, ``ring_decode_step``, ``make_train_step``) called
with the ``ShardCtx`` that ``mesh_ctx`` returns; ``InferenceEngine(...,
ctx=)`` places its weights, ring cache and staging cache with the same
helpers.
"""
from __future__ import annotations

import socket

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.distributed.context import ShardCtx
from repro_torch.distributed.sharding import (full, place_batch,  # noqa: F401
                                              place_cache, place_model,
                                              place_staging, placed_copy)


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
