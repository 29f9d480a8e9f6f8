"""Per-slot Mamba-2 decode state of the serving engine.

Counterpart of the mamba branch of ``repro/models/model.py:init_cache``
(:248-257): for every mamba layer, the pre-conv history of the last K-1
raw projections (``conv``: ``x`` [slots, K-1, d_inner], ``B``/``C``
[slots, K-1, G·N], in the weights' dtype) and the SSM state (``ssm``
[slots, H, P, N], float32), stacked over the mamba layers.  A prefill
writes a slot and ``models.decode_step`` reads and updates the active
slots in place.  The engine's ``slots`` list says which slots are in use:
a freed slot is simply overwritten by the next prefill.  At the published
width of mamba2-1.3b the SSM state is 2 MB per layer and slot.
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

    def decode_view(self, slots: List[int]) -> dict:
        """The mamba layers' part of ``models.decode_step``'s cache for the
        batch held in ``slots``."""
        return {"conv": self.conv, "ssm": self.ssm,
                "slots": torch.tensor(slots, dtype=torch.long,
                                      device=self.device)}

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
