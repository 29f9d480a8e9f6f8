"""Paged KV cache of the serving engine.

Counterpart of ``repro/engine/kv_cache.py:16-86`` (``PagedKVCache``): the
same allocator (``allocate``, ``extend``, ``release``, ``batch_tables``,
``utilization``) over torch page tensors on the device,
``[n_layers, P + 1, page, KV, hd]``.  Token writes are batched: one
indexed store per layer for a whole prompt (``write``) or, inside
``models.decode_step``, for one new token of every sequence in the batch.
The engine keys sequences by batch slot.

For the engine's fixed-shape decode step the cache also keeps a host-side
int32 block table of every slot at one width, ``ceil(max_len / page)``
(``table_view``), and each slot's context length.  Page ``P`` past the
allocator's pages is a scratch page that it never hands out: a free slot's
row names it in every entry and has length 1, so the padded rows of a decode
step write their K/V there and read nothing else.  A row changes only when
``allocate``, ``extend`` or ``release`` changes that slot's pages.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import layer_caches


class PagedKVCache:
    """Every attention layer's pages plus one allocator shared by them."""

    def __init__(self, cfg: ModelConfig, num_pages: int, page_size: int = 16,
                 *, slots: Optional[int] = None, max_len: Optional[int] = None,
                 dtype=torch.bfloat16, device="cuda"):
        """``slots`` (default ``num_pages``) sequences, keyed 0..slots-1,
        of at most ``max_len`` tokens each (default every page's)."""
        self.cfg = cfg
        self.num_pages = num_pages
        self.page_size = page_size
        self.device = resolve_device(device)
        self.n_attn_layers = sum(
            1 for kind, _ in layer_caches(cfg) if kind == "kv")
        self.scratch = num_pages
        shp = (self.n_attn_layers, num_pages + 1, page_size,
               cfg.num_kv_heads, cfg.head_dim)
        self.k_pages = torch.zeros(shp, dtype=dtype, device=self.device)
        self.v_pages = torch.zeros(shp, dtype=dtype, device=self.device)
        self.free: List[int] = list(range(num_pages))
        self.tables: Dict[int, List[int]] = {}
        self.lens: Dict[int, int] = {}
        width = self.pages_needed(max_len or num_pages * page_size)
        slots = num_pages if slots is None else slots
        self._table = np.full((slots, width), self.scratch, np.int32)
        self._lens = np.ones(slots, np.int32)
        self._changed: Set[int] = set(range(slots))

    # -- allocator -----------------------------------------------------------

    def pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def allocate(self, rid: int, n_tokens: int) -> List[int]:
        need = self.pages_needed(n_tokens)
        if len(self.free) < need:
            raise MemoryError(f"KV cache exhausted ({need} pages needed, "
                              f"{len(self.free)} free)")
        if need > self._table.shape[1]:
            raise ValueError(f"{n_tokens} tokens need {need} pages; a table "
                             f"row holds {self._table.shape[1]}")
        pages = [self.free.pop() for _ in range(need)]
        self.tables[rid] = pages
        self.lens[rid] = n_tokens
        self._set_row(rid)
        return pages

    def extend(self, rid: int, n_new: int = 1):
        new_len = self.lens[rid] + n_new
        need = self.pages_needed(new_len) - len(self.tables[rid])
        if need > len(self.free):
            raise MemoryError("KV cache exhausted on extend")
        if need > 0 and len(self.tables[rid]) + need > self._table.shape[1]:
            raise ValueError(f"{new_len} tokens overflow a table row of "
                             f"{self._table.shape[1]} pages")
        self.tables[rid] += [self.free.pop() for _ in range(need)]
        self.lens[rid] = new_len
        if need > 0:
            self._set_row(rid)
        else:
            self._lens[rid] = new_len

    def release(self, rid: int):
        self.free.extend(self.tables.pop(rid, []))
        self.lens.pop(rid, None)
        self._set_row(rid)

    def utilization(self) -> float:
        """Share of the allocator's pages in use (the scratch page is not
        one of them)."""
        return 1.0 - len(self.free) / self.num_pages

    # -- the fixed-width table of the engine's decode step -------------------

    def _set_row(self, rid: int):
        pages = self.tables.get(rid, [])
        row = self._table[rid]
        row[len(pages):] = self.scratch
        row[:len(pages)] = pages
        self._lens[rid] = self.lens.get(rid, 1)
        self._changed.add(rid)

    def table_view(self) -> Tuple[np.ndarray, np.ndarray]:
        """(block table int32 [slots, ceil(max_len / page)], context lengths
        int32 [slots]) of every slot, on the host.  A free slot's row names
        the scratch page in every entry and has length 1; a sequence's row
        names the scratch page past its own pages.  The arrays are the
        cache's own: read, do not write."""
        return self._table, self._lens

    def take_changed_rows(self) -> List[int]:
        """The slots whose table row changed since the last call (every
        slot at the first call)."""
        rows = sorted(self._changed)
        self._changed.clear()
        return rows

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

    def decode_view(self) -> dict:
        """The attention layers' part of ``models.decode_step``'s cache:
        every slot at the fixed width of ``table_view`` (row b is slot b),
        the table copied to the cache's device."""
        bt, lens = (torch.from_numpy(a).to(self.device)
                    for a in self.table_view())
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
