"""Sharding context threaded through model code.

Counterpart of ``repro/distributed/context.py:19-87``.  ``ShardCtx`` names
the axes of a ``torch.distributed`` ``DeviceMesh`` (built with
``mesh_dim_names``) so that the layers can place their tensors: the MoE
dispatch and the kernels run under ``local_map`` with explicit layouts, and
everything else is DTensor code whose placements follow from the
parameters' and inputs' (``distributed/sharding.py``), with ``constraint``
hints where the reference puts ``with_sharding_constraint``.  A spec is a
tuple with one entry per tensor dim: ``None``, an axis name, or a tuple of
names, as the reference's ``PartitionSpec`` holds them.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.distributed.sharding import placements


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    mesh: Any = None                          # a DeviceMesh, or None
    data_axes: Tuple[str, ...] = ("data",)    # batch / token axes (incl. "pod")
    model_axis: str = "model"                 # tensor-parallel axis
    seq_axis: Optional[str] = None            # KV-sequence sharding (long ctx)
    use_shard_map_moe: bool = True

    @property
    def enabled(self) -> bool:
        return self.mesh is not None

    def axis_size(self, name: str) -> int:
        if not self.enabled:
            return 1
        return self.mesh.size(self.mesh.mesh_dim_names.index(name))

    @property
    def dp_size(self) -> int:
        s = 1
        for a in self.data_axes:
            s *= self.axis_size(a)
        return s

    @property
    def tp_size(self) -> int:
        return self.axis_size(self.model_axis)

    def constraint(self, x, *spec):
        """``x`` redistributed to ``spec`` if a mesh is active and ``x`` is a
        DTensor (a no-op otherwise): the reference's
        ``with_sharding_constraint``."""
        if not self.enabled or not _is_dtensor(x):
            return x
        return x.redistribute(self.mesh, placements(spec, self.mesh))

    def batch_spec_entry(self, batch_size: int):
        """Largest prefix of data axes that divides the batch dim."""
        axes = []
        s = 1
        for a in self.data_axes:
            if batch_size % (s * self.axis_size(a)) == 0:
                axes.append(a)
                s *= self.axis_size(a)
        if not axes:
            return None
        return tuple(axes) if len(axes) > 1 else axes[0]

    def model_axis_if_divides(self, dim: int):
        if self.enabled and dim % self.tp_size == 0:
            return self.model_axis
        return None

    def seq_entry(self, L: int):
        """Megatron-style sequence parallelism: shard the token dim of the
        residual stream over the model axis between blocks."""
        if self.enabled and L > 1 and L % self.tp_size == 0:
            return self.model_axis
        return None

    def heads_spec(self, n_heads: int, head_dim: int):
        """(head_entry, hd_entry) for sharding a [.., H, hd] tensor over the
        model axis: prefer whole heads, fall back to head_dim, else None."""
        if not self.enabled:
            return None
        if n_heads % self.tp_size == 0:
            return (self.model_axis, None)
        if head_dim % self.tp_size == 0:
            return (None, self.model_axis)
        return None

    def grad_constraint(self, x, *spec):
        """``x`` as it is, but its cotangent redistributed to ``spec`` in the
        backward pass (a no-op on a plain tensor or with the context off):
        where the next op would hand back a cotangent sharded where an
        earlier reshape cannot take it."""
        if not self.enabled or not _is_dtensor(x):
            return x
        return _GradTo.apply(x, self.mesh, placements(spec, self.mesh))

    def data_partial(self, spec) -> tuple:
        """Placements of a weight's gradient inside ``local_map``: each data
        shard's part (``Partial``) over the data axes, ``spec``'s placement
        over the others."""
        from torch.distributed.tensor import Partial
        return tuple(Partial() if a in self.data_axes else p
                     for a, p in zip(self.mesh.mesh_dim_names,
                                     placements(spec, self.mesh)))


class _GradTo(torch.autograd.Function):
    @staticmethod
    def forward(fn_ctx, x, mesh, pl):
        fn_ctx.mesh, fn_ctx.pl = mesh, pl
        return x.view_as(x)

    @staticmethod
    def backward(fn_ctx, g):
        return g.redistribute(fn_ctx.mesh, fn_ctx.pl), None, None


class _ContiguousGrad(torch.autograd.Function):
    @staticmethod
    def forward(fn_ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(fn_ctx, g):
        return g.contiguous()


def contiguous_grads(*ts):
    """``ts`` as they are, their gradients made contiguous: inside
    ``local_map`` a body's input gradients become local shards of DTensors,
    whose later reshapes assume contiguous shards (an einsum's gradient
    may come back transposed)."""
    return tuple(_ContiguousGrad.apply(t) if t.requires_grad else t
                 for t in ts)


def local_rows(mesh, placements, n: int) -> Tuple[int, int]:
    """(first, count) of the rows of dim 0 (of ``n``) that this rank's
    shard holds under ``placements`` over ``mesh``: the mesh dims that
    shard dim 0 split it in mesh order, the outer first, as
    ``sharding.placements`` lays them out (evenly)."""
    coord = mesh.get_coordinate()
    idx, parts = 0, 1
    for i, pl in enumerate(placements):
        if pl.is_shard(0):
            idx, parts = idx * mesh.size(i) + coord[i], parts * mesh.size(i)
    return idx * (n // parts), n // parts


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def replicated_like(t, like):
    """``t`` as a DTensor replicated over ``like``'s mesh where ``like`` is a
    DTensor and ``t`` is not (a mask, RoPE's angles): an operand that the
    backward pass may meet outside any implicit replication.  Else ``t``."""
    if not _is_dtensor(like) or _is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


@contextlib.contextmanager
def sharded_scope(ctx: "ShardCtx"):
    """Under an active mesh, DTensor's implicit replication: a plain tensor
    met with DTensors (positions, a comparison's operand) counts as
    replicated.  Re-entrant, unlike ``implicit_replication`` itself, whose
    exit turns it off whatever an outer scope wants."""
    if not ctx.enabled:
        yield
        return
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    if DTensor._op_dispatcher._allow_implicit_replication:
        yield
        return
    with implicit_replication():
        yield


NULL_CTX = ShardCtx()
