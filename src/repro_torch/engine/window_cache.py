"""Per-slot K/V rings of the window layers of the serving engine.

Counterpart of the window branch of ``repro/models/model.py:init_cache``
(:239-241), a ring of ``S = min(window, max_len)`` rows per sequence, and
of ``_to_ring`` (:125-133) and ``ring_convert_cache`` (:347-370), which
put a prompt's last ``min(L, S)`` rows at ``t % S``.  The ring is laid
out so that the paged decode kernel reads it unchanged: slot s owns pages
``s * n .. s * n + n - 1`` (``n = ceil(S / page)``) of
``k``/``v`` [n window layers, slots * n, page, KV, hd] in the weights'
dtype, and ``tables`` is the constant int32 identity table [slots, n] on
the device.  Ring row r is row ``r % page`` of the slot's page ``r //
page``; rows past S are never written or read.  ``models.decode_step``
writes each new token's row at ``pos % S`` and attends over the first
``min(context_lens, S)`` rows, every slot at once (row b of the decode
batch is slot b).  Rows an earlier request left in a slot stay masked:
the kernel reads no row at or past the context, and a new prompt rewrites
rows ``0 .. min(L, S) - 1``.  A free slot decodes at length 0 (without a
paged cache) or 1 (with one) and writes its own row 0, which the next
prefill there overwrites.

Window layers hold no pages of the paged cache, whose one block table per
sequence is shared by the full layers.  At gemma3-27b's width (52 window
layers, 16 KV heads of 128, S = 1024) a slot's rings take 436 MB.
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import layer_caches


class WindowCache:
    """Every window layer's ring for ``slots`` slots."""

    def __init__(self, cfg: ModelConfig, slots: int, max_len: int,
                 page_size: int = 16, *, dtype=torch.bfloat16, device="cuda"):
        self.device = resolve_device(device)
        windows = {b.window for b in cfg.layer_list() if b.mixer == "window"}
        if len(windows) > 1:
            raise NotImplementedError(
                f"{cfg.name}: window layers of sizes {sorted(windows)}; the "
                f"ring cache holds one ring size")
        (window,) = windows
        self.size = min(window, max_len)
        self.page_size = page_size
        self.pages_per_slot = -(-self.size // page_size)
        n = sum(1 for kind, _ in layer_caches(cfg) if kind == "win")
        shp = (n, slots * self.pages_per_slot, page_size, cfg.num_kv_heads,
               cfg.head_dim)
        self.k = torch.zeros(shp, dtype=dtype, device=self.device)
        self.v = torch.zeros(shp, dtype=dtype, device=self.device)
        self.tables = torch.arange(
            slots * self.pages_per_slot, dtype=torch.int32,
            device=self.device).view(slots, self.pages_per_slot)

    def decode_view(self) -> dict:
        """The window layers' part of ``models.decode_step``'s cache: every
        slot's ring, its identity table and the ring size."""
        return {"win_k": self.k, "win_v": self.v, "win_tables": self.tables,
                "win_size": self.size}

    def write(self, slot: int, states: List[tuple]):
        """Store one request's per-window-layer (k, v) [L, KV, hd] from its
        prefill (or its staged chunks): the last ``min(L, S)`` rows at ring
        rows ``t % S`` of ``slot``."""
        if len(states) != self.k.shape[0]:
            raise ValueError(f"{len(states)} layer states for "
                             f"{self.k.shape[0]} window layers")
        L = states[0][0].shape[0]
        take = min(L, self.size)
        t = torch.arange(L - take, L, device=self.device)
        idx = slot * self.pages_per_slot * self.page_size + t % self.size
        for layer, (k, v) in enumerate(states):
            self.k[layer].view(-1, *self.k.shape[3:])[idx] = k[L - take:]
            self.v[layer].view(-1, *self.v.shape[3:])[idx] = v[L - take:]
