"""Per-slot Mamba-2 decode state of the serving engine.

Counterpart of the mamba branch of ``repro/models/model.py:init_cache``
(:248-257): for every mamba layer, the pre-conv history of the last K-1
raw projections (``conv``: ``x`` [slots, K-1, d_inner], ``B``/``C``
[slots, K-1, G·N], in the weights' dtype) and the SSM state (``ssm``
[slots, H, P, N], float32), stacked over the mamba layers.  A prefill
writes a slot and ``models.decode_step`` updates every slot in place: row b
of the engine's fixed-shape decode batch is slot b.  The engine's ``slots``
list says which slots are in use: a free slot's state evolves on token 0
and is simply overwritten by the next prefill.  At the published width of
mamba2-1.3b the SSM state is 2 MB per layer and slot.
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import layer_caches


class SSMStateCache:
    """Every mamba layer's conv history and SSM state for ``slots`` slots."""

    def __init__(self, cfg: ModelConfig, slots: int, *, dtype=torch.bfloat16,
                 device="cuda"):
        self.device = resolve_device(device)
        s = cfg.ssm
        n = sum(1 for kind, _ in layer_caches(cfg) if kind == "ssm")
        di, gn = s.d_inner(cfg.d_model), s.n_groups * s.d_state
        K1 = s.d_conv - 1

        def zeros(*shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=self.device)

        self.conv = {"x": zeros(n, slots, K1, di), "B": zeros(n, slots, K1, gn),
                     "C": zeros(n, slots, K1, gn)}
        self.ssm = zeros(n, slots, s.n_heads(cfg.d_model), s.head_dim,
                         s.d_state, dt=torch.float32)

    @property
    def slot_bytes(self) -> int:
        """Bytes one slot holds over every mamba layer: its conv history
        and its SSM state, what ``write`` stores."""
        bufs = (*self.conv.values(), self.ssm)
        return sum(b[:, 0].numel() * b.element_size() for b in bufs)

    def decode_view(self) -> dict:
        """The mamba layers' part of ``models.decode_step``'s cache: every
        slot, row b of the decode batch being slot b."""
        return {"conv": self.conv, "ssm": self.ssm}

    def write(self, slot: int, states: List[tuple]):
        """Store one request's per-mamba-layer (conv tail {"x", "B", "C"}
        [K-1, ·], SSM state [H, P, N]) from its prefill in ``slot``."""
        if len(states) != self.ssm.shape[0]:
            raise ValueError(f"{len(states)} layer states for "
                             f"{self.ssm.shape[0]} mamba layers")
        for layer, (conv, ssm) in enumerate(states):
            for k, buf in self.conv.items():
                buf[layer, slot] = conv[k]
            self.ssm[layer, slot] = ssm
