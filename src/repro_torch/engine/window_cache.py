"""Per-slot K/V rings of the window layers of the serving engine.

Counterpart of the window branch of ``repro/models/model.py:init_cache``
(:239-241), a ring of ``S = min(window, max_len)`` rows per sequence and
layer, and of ``_to_ring`` (:125-133) and ``ring_convert_cache``
(:347-370), which put a prompt's last ``min(L, S)`` rows at ``t % S``.
Window layers may differ in size, as the reference sizes each layer's
ring alone (``_apply_block``, :98): the layers of one size share a
``RingStack``.  A stack is laid out so that the paged decode kernel reads
it unchanged: slot s owns pages ``s * n .. s * n + n - 1`` (``n = ceil(S /
page)``) of ``k``/``v`` [its layers, slots * n, page, KV, hd] in the
weights' dtype, and ``tables`` is its constant int32 identity table
[slots, n] on the device.  Ring row r is row ``r % page`` of the slot's
page ``r // page``; rows past S are never written or read.
``models.decode_step`` writes each new token's row at ``pos % S`` and
attends over the first ``min(context_lens, S)`` rows, every slot at once
(row b of the decode batch is slot b).  Rows an earlier request left in a
slot stay masked: the kernel reads no row at or past the context, and a
new prompt rewrites rows ``0 .. min(L, S) - 1``.  A free slot decodes at
length 0 (without a paged cache) or 1 (with one) and writes its own row
0, which the next prefill there overwrites.

Window layers hold no pages of the paged cache, whose one block table per
sequence is shared by the full layers.  At gemma3-27b's width (52 window
layers, 16 KV heads of 128, S = 1024) a slot's rings take 436 MB.
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device


class RingStack:
    """The rings of ``n_layers`` window layers of one size ``size`` for
    ``slots`` slots."""

    def __init__(self, size: int, n_layers: int, slots: int, page_size: int,
                 kv_heads: int, head_dim: int, dtype, device):
        self.size = size
        self.page_size = page_size
        self.pages_per_slot = -(-size // page_size)
        shp = (n_layers, slots * self.pages_per_slot, page_size, kv_heads,
               head_dim)
        self.k = torch.zeros(shp, dtype=dtype, device=device)
        self.v = torch.zeros(shp, dtype=dtype, device=device)
        self.tables = torch.arange(
            slots * self.pages_per_slot, dtype=torch.int32,
            device=device).view(slots, self.pages_per_slot)

    def write(self, slot: int, states: List[tuple]):
        """Each of this stack's layers' (k, v) [L, KV, hd], in rank order:
        the last ``min(L, S)`` rows at ring rows ``t % S`` of ``slot``."""
        L = states[0][0].shape[0]
        take = min(L, self.size)
        t = torch.arange(L - take, L, device=self.k.device)
        idx = slot * self.pages_per_slot * self.page_size + t % self.size
        for layer, (k, v) in enumerate(states):
            self.k[layer].view(-1, *self.k.shape[3:])[idx] = k[L - take:]
            self.v[layer].view(-1, *self.v.shape[3:])[idx] = v[L - take:]


class WindowCache:
    """Every window layer's ring for ``slots`` slots: one ``RingStack``
    per distinct ``S = min(window, max_len)``, in the order the sizes first
    appear.  ``where[i]`` is (stack, rank in it) of the i-th window layer
    in ``cfg.layer_list()`` order."""

    def __init__(self, cfg: ModelConfig, slots: int, max_len: int,
                 page_size: int = 16, *, dtype=torch.bfloat16, device="cuda"):
        self.device = resolve_device(device)
        self.page_size = page_size
        sizes = [min(b.window, max_len) for b in cfg.layer_list()
                 if b.mixer == "window"]
        order = list(dict.fromkeys(sizes))
        counts = [0] * len(order)
        self.where = []
        for S in sizes:
            j = order.index(S)
            self.where.append((j, counts[j]))
            counts[j] += 1
        self.stacks = [RingStack(S, n, slots, page_size, cfg.num_kv_heads,
                                 cfg.head_dim, dtype, self.device)
                       for S, n in zip(order, counts)]

    @property
    def nbytes(self) -> int:
        """The device bytes of every ring, K and V."""
        return sum(t.numel() * t.element_size()
                   for st in self.stacks for t in (st.k, st.v))

    def decode_view(self) -> dict:
        """The window layers' part of ``models.decode_step``'s cache: per
        size, (K, V, identity table, size) of its stack, and per window
        layer its (stack, rank)."""
        return {"win_stacks": tuple((st.k, st.v, st.tables, st.size)
                                    for st in self.stacks),
                "win_where": tuple(self.where)}

    def write(self, slot: int, states: List[tuple]):
        """Store one request's per-window-layer (k, v) [L, KV, hd] from its
        prefill (or its staged chunks): each layer's last ``min(L, S)``
        rows at its ring's rows ``t % S`` of ``slot``."""
        if len(states) != len(self.where):
            raise ValueError(f"{len(states)} layer states for "
                             f"{len(self.where)} window layers")
        for j, stack in enumerate(self.stacks):
            stack.write(slot, [st for (i, _), st in zip(self.where, states)
                               if i == j])
