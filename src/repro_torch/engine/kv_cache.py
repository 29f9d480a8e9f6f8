"""Paged KV cache of the serving engine.

Counterpart of ``repro/engine/kv_cache.py:16-86`` (``PagedKVCache``): the
same allocator (``allocate``, ``extend``, ``release``, ``batch_tables``,
``utilization``) over torch page tensors on the device,
``[n_layers, P, page, KV, hd]``.  Token writes are batched: one indexed
store per layer for a whole prompt (``write``) or, inside
``models.decode_step``, for one new token of every sequence in the batch.
The engine keys sequences by batch slot.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import layer_caches


class PagedKVCache:
    """Every attention layer's pages plus one allocator shared by them."""

    def __init__(self, cfg: ModelConfig, num_pages: int, page_size: int = 16,
                 *, dtype=torch.bfloat16, device="cuda"):
        self.cfg = cfg
        self.num_pages = num_pages
        self.page_size = page_size
        self.device = resolve_device(device)
        self.n_attn_layers = sum(
            1 for kind, _ in layer_caches(cfg) if kind == "kv")
        shp = (self.n_attn_layers, num_pages, page_size, cfg.num_kv_heads,
               cfg.head_dim)
        self.k_pages = torch.zeros(shp, dtype=dtype, device=self.device)
        self.v_pages = torch.zeros(shp, dtype=dtype, device=self.device)
        self.free: List[int] = list(range(num_pages))
        self.tables: Dict[int, List[int]] = {}
        self.lens: Dict[int, int] = {}

    # -- allocator -----------------------------------------------------------

    def pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def allocate(self, rid: int, n_tokens: int) -> List[int]:
        need = self.pages_needed(n_tokens)
        if len(self.free) < need:
            raise MemoryError(f"KV cache exhausted ({need} pages needed, "
                              f"{len(self.free)} free)")
        pages = [self.free.pop() for _ in range(need)]
        self.tables[rid] = pages
        self.lens[rid] = n_tokens
        return pages

    def extend(self, rid: int, n_new: int = 1):
        new_len = self.lens[rid] + n_new
        have = len(self.tables[rid]) * self.page_size
        while new_len > have:
            if not self.free:
                raise MemoryError("KV cache exhausted on extend")
            self.tables[rid].append(self.free.pop())
            have += self.page_size
        self.lens[rid] = new_len

    def release(self, rid: int):
        self.free.extend(self.tables.pop(rid, []))
        self.lens.pop(rid, None)

    def utilization(self) -> float:
        return 1.0 - len(self.free) / self.num_pages

    # -- batched views and writes --------------------------------------------

    def batch_tables(self, rids: List[int]):
        """(block_tables int32 [B, max pages], context_lens int32 [B]) on the
        cache's device; short rows are padded with page 0, never read."""
        max_pages = max(len(self.tables[r]) for r in rids)
        bt = np.zeros((len(rids), max_pages), np.int32)
        for i, r in enumerate(rids):
            pages = self.tables[r]
            bt[i, :len(pages)] = pages
        lens = np.array([self.lens[r] for r in rids], np.int32)
        return (torch.from_numpy(bt).to(self.device),
                torch.from_numpy(lens).to(self.device))

    def decode_view(self, rids: List[int]) -> dict:
        """The attention layers' part of ``models.decode_step``'s cache for
        the batch ``rids``."""
        bt, lens = self.batch_tables(rids)
        return {"k_pages": self.k_pages, "v_pages": self.v_pages,
                "block_tables": bt, "context_lens": lens}

    def token_index(self, rid: int, start: int, n: int) -> torch.Tensor:
        """Flat row indices (page * page_size + slot) of positions
        start..start+n-1 of ``rid``, on the cache's device."""
        pos = np.arange(start, start + n)
        pages = np.asarray(self.tables[rid], np.int64)[pos // self.page_size]
        return torch.from_numpy(pages * self.page_size
                                + pos % self.page_size).to(self.device)

    def write(self, layer: int, index: torch.Tensor, k, v):
        """Store k/v [n, KV, hd] at flat rows ``index`` of one layer: one
        indexed store each."""
        flat = (-1,) + self.k_pages.shape[3:]
        self.k_pages[layer].view(flat)[index] = k
        self.v_pages[layer].view(flat)[index] = v
