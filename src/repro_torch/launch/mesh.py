"""Production mesh construction.

Counterpart of ``repro/launch/mesh.py``.  Kept as functions (never
module-level constants), so importing this module touches no device and no
process group.  A mesh is a ``torch.distributed`` ``DeviceMesh`` over the
world that ``torch.distributed`` already has; ``fake_world`` starts a fake
one of n ranks in this process, for the dry run.
"""
from __future__ import annotations


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cpu"):
    """Single pod: 16x16 = 256 ranks ("data", "model").
    Multi-pod: 2x16x16 = 512 ranks ("pod", "data", "model")."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_local_mesh(data: int = 1, model: int = 1, device_type: str = "cpu"):
    """A (data, model) mesh over a small world (tests on the CPU, one card)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))


def data_axes_of(mesh) -> tuple:
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def fake_world(n: int) -> None:
    """Start (or restart at a new size) a fake process group of ``n`` ranks
    in this process, this process being rank 0: collectives on it move no
    data, so a step can be traced on meta tensors as if on n devices."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() == n and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=_fake_store(), rank=0,
                            world_size=n)


def _fake_store():
    """The fake process group's store: torch's test-only ``FakeStore`` (a
    private module), registering the ``fake`` backend as it imports."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    return FakeStore()
