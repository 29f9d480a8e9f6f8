"""Per-slot latent cache of the MLA layers of the serving engine.

Counterpart of the ``mla`` branch of ``repro/models/model.py:init_cache``
(:244-247): for every MLA layer, the compressed KV rows ``ckv`` [slots,
max_len, kv_lora] and the rotated key rows ``kr`` [slots, max_len, rope]
in the weights' dtype, slot == absolute position, stacked over the MLA
layers.  A prefill writes a slot's first rows and ``models.decode_step``
writes each new token's row in place, every slot at once: row b of the
engine's fixed-shape decode batch is slot b.  Rows past a slot's length
hold an earlier request's values and are masked.  A free slot decodes at
length 0 and writes its own row 0, which the next prefill there
overwrites.  At deepseek-v2-lite-16b's width (27 layers, 512 + 64) eight
slots of 4096 tokens take 1.02 GB.
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import layer_caches


class LatentCache:
    """Every MLA layer's latent rows for ``slots`` slots of ``max_len``."""

    def __init__(self, cfg: ModelConfig, slots: int, max_len: int, *,
                 dtype=torch.bfloat16, device="cuda"):
        self.device = resolve_device(device)
        m = cfg.mla
        n = sum(1 for kind, _ in layer_caches(cfg) if kind == "mla")
        self.ckv = torch.zeros((n, slots, max_len, m.kv_lora_rank),
                               dtype=dtype, device=self.device)
        self.kr = torch.zeros((n, slots, max_len, m.rope_head_dim),
                              dtype=dtype, device=self.device)

    def decode_view(self) -> dict:
        """The MLA layers' part of ``models.decode_step``'s cache: every
        slot, row b of the decode batch being slot b."""
        return {"ckv": self.ckv, "kr": self.kr}

    def write(self, slot: int, states: List[tuple]):
        """Store one request's per-MLA-layer (c_kv [L, kv_lora], k_rope
        [L, rope]) from its prefill in rows 0..L-1 of ``slot``."""
        if len(states) != self.ckv.shape[0]:
            raise ValueError(f"{len(states)} layer states for "
                             f"{self.ckv.shape[0]} MLA layers")
        n = states[0][0].shape[0] if states else 0
        if n > self.ckv.shape[2]:
            raise ValueError(f"{n} rows, the slot holds {self.ckv.shape[2]}")
        for layer, (ckv, kr) in enumerate(states):
            self.ckv[layer, slot, :n] = ckv
            self.kr[layer, slot, :n] = kr
