"""Per-device cost of a step, counted as it runs: the counterpart of
``repro/launch/hlo_cost.py``.

The reference reads XLA's post-SPMD HLO text: ``HloCost`` parses it into
computations and ``collective_stats`` finds the collectives with a regex.
PyTorch runs the step op by op and leaves no HLO, so neither has an input
here and neither is copied.  Instead one ``TorchDispatchMode``,
``OpCounter``, sees every op of one rank as it runs, on its local shards:
where an op's arguments are DTensors it steps aside (``NotImplemented``),
DTensor's dispatch runs and the local ops and collectives it issues come
back through the mode, so the counts are one device's, not the global
ones a mode sees at the DTensor level.  DTensor's sharding propagation
runs each new op once on fake tensors of the global shapes to learn its
output's; those calls are not counted.  It counts

* flops: ``torch.utils.flop_counter``'s formulas on the local shapes,
  plus the flops a kernel wrapper reports for a meta call
  (``kernels/_build.record_cost``);
* a bytes proxy: operands plus result of every op that is not a view or
  an allocation (``hlo_cost.py:136-142``'s proxy without XLA's fusion:
  eager per-op traffic), plus the bytes a kernel reports;
* collectives by kind under the reference's names, with count and wire
  bytes: the result's bytes, twice for an all-reduce (``hlo_cost.py:112``);
* peak live bytes: the storages that ops allocate, alive from the op to
  the death of their last reference (autograd's saved tensors keep
  theirs alive), on top of what existed when counting began.

``analyze`` gives the keys of the reference's ``analyze_hlo``.
"""
from __future__ import annotations

import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import _build

_COLLECTIVES = (("all_gather", "all-gather"), ("reduce_scatter",
                "reduce-scatter"), ("all_reduce", "all-reduce"),
                ("all_to_all", "all-to-all"), ("permute", "collective-permute"))
# ops that move no data: a wait, the autograd wrapper of a collective's
# result, fresh allocations
_NO_TRAFFIC = ("wait_tensor", "_wrap_tensor_autograd", "empty", "empty_like",
               "empty_strided", "new_empty", "new_empty_strided")


def _tensors(xs) -> list:
    """The tensors of an op's arguments or results: top-level, or in a
    list or tuple (``cat``'s inputs, ``split``'s outputs)."""
    out = []
    for a in xs:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(b for b in a if isinstance(b, torch.Tensor))
    return out


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _collective_kind(func):
    if func.namespace not in ("_c10d_functional", "_c10d_functional_autograd",
                              "c10d"):
        return None
    name = func.__name__
    for key, kind in _COLLECTIVES:
        if key in name:
            return kind
    return None


class OpCounter(TorchDispatchMode):
    """Counts the ops of one rank while it is entered (see the module)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: Dict[str, dict] = {}
        self.kernels: Dict[str, dict] = {}
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, int] = {}
        self._suspended = 0
        self._restore = None

    # -- entering and leaving -------------------------------------------------
    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        orig = ShardingPropagator._propagate_tensor_meta_non_cached
        counter = self

        def fake_shapes(prop, op_schema):
            counter._suspended += 1
            try:
                return orig(prop, op_schema)
            finally:
                counter._suspended -= 1
        ShardingPropagator._propagate_tensor_meta_non_cached = fake_shapes
        self._restore = (ShardingPropagator, orig)
        _build.COST_SINKS.append(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        cls, orig = self._restore
        cls._propagate_tensor_meta_non_cached = orig
        _build.COST_SINKS.remove(self._kernel)
        return super().__exit__(*exc)

    # -- counting -------------------------------------------------------------
    def _kernel(self, name: str, flops: float, nbytes: float) -> None:
        e = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0})
        e["calls"] += 1
        e["flops"] += flops
        e["bytes"] += nbytes
        self.flops += flops
        self.bytes += nbytes

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._suspended:
            return out
        name = func.__name__
        ins = _tensors((*args, *kwargs.values()))
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        for o in outs:
            self._track(o)
        kind = _collective_kind(func)
        if kind is not None and outs:
            rb = sum(_nbytes(o) for o in outs)
            mult = 2.0 if kind == "all-reduce" else 1.0
            e = self.collectives.setdefault(kind, {"count": 0,
                                                   "wire_bytes": 0.0})
            e["count"] += 1
            e["wire_bytes"] += rb * mult
            self.bytes += 2 * rb
            return out
        packet = func.overloadpacket
        if packet in _flop_registry():
            self.flops += _flop_registry()[packet](*args, **kwargs,
                                                   out_val=out)
        if not func.is_view and not any(n in name.split(".")[0]
                                        for n in _NO_TRAFFIC):
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        return out

    def analyze(self) -> dict:
        """The reference's ``analyze_hlo`` keys, and the kernels' share."""
        wire = sum(e["wire_bytes"] for e in self.collectives.values())
        return {"flops_per_device": self.flops,
                "bytes_accessed_per_device": self.bytes,
                "collective_wire_bytes_per_device": wire,
                "collectives": {k: dict(v) for k, v in
                                self.collectives.items()},
                "kernels": {k: dict(v) for k, v in self.kernels.items()}}


def _flop_registry():
    from torch.utils.flop_counter import flop_registry
    return flop_registry
