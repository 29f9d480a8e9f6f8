"""Per-instance serving engine: continuous batching over the port's model.

Counterpart of ``repro/engine/engine.py:37-216`` with the same surface:
``submit``, ``step``, ``run_until_drained``, ``checkpoint_request``,
``drain_events`` (the black-box timing stream the EMA estimator reads),
``prefill_chunk`` staging with the chunkable-config gate, and a bounded
events deque.  Deliberate differences:

* decode attends over a paged KV cache (``PagedKVCache``) through the paged
  kernel and runs only the active rows; the JAX engine decodes every slot
  of a dense per-slot ring cache.  The engine holds pages only for
  attention layers and per-slot states (``SSMStateCache``) only for mamba
  layers; decode updates the active slots' states in place;
* chunked prefill stages into a linear K/V buffer, as the JAX engine does,
  and flash attention sees it cut to ``pos0 + C`` rows.  When the prompt is
  complete its rows are copied into freshly allocated pages: for full
  attention that is what ``ring_convert_cache`` reduces to;
* ``checkpoint_request`` also releases the request's pages; its state
  slot is free once the engine's ``slots`` entry is, and the next prefill
  there overwrites it;
* every timing event synchronizes the device before the clock is read, so
  it times the work and not its launch (the JAX engine reads the clock
  before the jitted decode has finished);
* the engine takes ``dtype`` (for weights it draws itself; given weights
  keep theirs), ``page_size``, ``num_pages`` and ``device``;
* prefill covers every token a request holds, so a request resubmitted
  after ``checkpoint_request`` resumes with its generated tokens in the
  cache;
* non-finite logits raise ``FloatingPointError`` instead of being served.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, synchronize
from repro_torch.engine.kv_cache import PagedKVCache
from repro_torch.engine.state_cache import SSMStateCache
from repro_torch.models.model import (Model, decode_step, init_cache,
                                      init_params, layer_caches, prefill,
                                      prefill_chunk)


@dataclasses.dataclass
class EngineRequest:
    rid: int
    tokens: List[int]                 # prompt + generated so far
    prompt_len: int
    max_new_tokens: int = 64
    eos_id: Optional[int] = None
    done: bool = False

    @property
    def generated(self) -> List[int]:
        return self.tokens[self.prompt_len:]


class InferenceEngine:
    """Continuous-batching engine: ``max_batch`` slots over one paged KV
    cache (attention layers) and one per-slot state cache (mamba layers)."""

    def __init__(self, cfg: ModelConfig, params: Optional[Model] = None, *,
                 max_batch: int = 8, max_len: int = 256, seed: int = 0,
                 prefill_chunk: Optional[int] = None, max_events: int = 4096,
                 dtype=torch.float32, page_size: int = 16,
                 num_pages: Optional[int] = None, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        if params is None:
            params = init_params(cfg, seed=seed, dtype=dtype,
                                 device=self.device)
        elif params.device.type != self.device.type:
            raise ValueError(f"weights on {params.device}, engine on "
                             f"{self.device}")
        self.params = params
        self._layer_caches = layer_caches(cfg)
        kinds = {kind for kind, _ in self._layer_caches}
        if num_pages is None:
            num_pages = max_batch * -(-max_len // page_size)
        self.cache = (PagedKVCache(cfg, num_pages, page_size,
                                   dtype=params.dtype, device=self.device)
                      if "kv" in kinds else None)
        self.states = (SSMStateCache(cfg, max_batch, dtype=params.dtype,
                                     device=self.device)
                       if "ssm" in kinds else None)
        self.slots: List[Optional[EngineRequest]] = [None] * max_batch
        self.queue: List[EngineRequest] = []
        # chunked prefill: only full/window mixers are chunk-resumable
        chunkable = {b.mixer for b in cfg.layer_list()} <= {"full", "window"}
        self.prefill_chunk = (prefill_chunk
                              if (prefill_chunk and chunkable) else None)
        # one request staged at a time, into one reused linear buffer
        self._stage_cache = (init_cache(cfg, 1, max_len, dtype=params.dtype,
                                        device=self.device)
                             if self.prefill_chunk else None)
        self._staging: Optional[dict] = None
        self.events: Deque[tuple] = deque(maxlen=max_events)
        self.completed: List[EngineRequest] = []

    # -- request lifecycle -----------------------------------------------------

    def submit(self, req: EngineRequest):
        if not 0 < len(req.tokens) < self.max_len:
            raise ValueError(f"request {req.rid}: {len(req.tokens)} tokens, "
                             f"engine holds 1..{self.max_len - 1}")
        self.queue.append(req)

    def drain_events(self) -> List[tuple]:
        """Hand the accumulated (kind, size, dt) timing events to the
        caller and clear the buffer — the estimator-facing consumer API."""
        ev = list(self.events)
        self.events.clear()
        return ev

    def checkpoint_request(self, rid: int) -> Optional[EngineRequest]:
        """Token-ID snapshot of an in-flight request (migration / failure
        resubmission): frees its slot (and with it its mamba state) and its
        pages, returns the portable state."""
        if self._staging is not None and self._staging["req"].rid == rid:
            req = self._staging["req"]
            self._staging = None        # partial prefill is discarded:
            return req                  # token IDs re-prefill at the target
        for i, r in enumerate(self.slots):
            if r is not None and r.rid == rid:
                self._free(i)
                return r
        for r in self.queue:
            if r.rid == rid:
                self.queue.remove(r)
                return r
        return None

    @property
    def load(self) -> int:
        """Requests queued, staged or running."""
        return (len(self.queue) + (self._staging is not None)
                + sum(r is not None for r in self.slots))

    # -- helpers ---------------------------------------------------------------

    def _clock(self) -> float:
        synchronize(self.device)
        return time.perf_counter()

    def _tokens(self, toks: List[int]) -> torch.Tensor:
        return torch.tensor(toks, dtype=torch.long, device=self.device)

    @staticmethod
    def _greedy(logits) -> List[int]:
        if not bool(torch.isfinite(logits).all()):
            raise FloatingPointError("non-finite logits")
        return logits.argmax(dim=-1).tolist()

    def _to_pages(self, slot: int, kv_rows):
        """Allocate pages for ``slot`` and write per-attention-layer (k, v)
        rows [n, KV, hd] into them."""
        n = kv_rows[0][0].shape[0]
        self.cache.allocate(slot, n)
        idx = self.cache.token_index(slot, 0, n)
        for layer, (k, v) in enumerate(kv_rows):
            self.cache.write(layer, idx, k, v)

    def _free(self, slot: int):
        self.slots[slot] = None
        if self.cache is not None:
            self.cache.release(slot)

    # -- admission: one-shot and chunked prefill ------------------------------

    def _admit(self):
        for i in range(self.max_batch):
            if self.slots[i] is None and self.queue:
                req = self.queue.pop(0)
                t0 = self._clock()
                self._prefill_into_slot(i, req)
                self.events.append(("prefill", req.prompt_len,
                                    self._clock() - t0))

    def _prefill_into_slot(self, slot: int, req: EngineRequest):
        logits, states = prefill(self.params, self._tokens(req.tokens)[None])
        kv = [(a[0], b[0]) for (kind, _), (a, b)
              in zip(self._layer_caches, states) if kind == "kv"]
        ssm = [({k: v[0] for k, v in a.items()}, b[0]) for (kind, _), (a, b)
               in zip(self._layer_caches, states) if kind == "ssm"]
        if self.cache is not None:
            self._to_pages(slot, kv)
        if self.states is not None:
            self.states.write(slot, ssm)
        req.tokens.append(self._greedy(logits)[0])
        self.slots[slot] = req

    def _advance_staged(self):
        """Begin and/or advance the staged prefill by at most one chunk —
        the per-iteration prefill-token budget."""
        if self._staging is None:
            free = next((i for i, r in enumerate(self.slots) if r is None),
                        None)
            if free is None or not self.queue:
                return
            self._staging = {"slot": free, "req": self.queue.pop(0),
                             "t0": self._clock()}
            self._stage_cache["pos"] = 0
        st, sc = self._staging, self._stage_cache
        req, done = st["req"], sc["pos"]
        n_total = len(req.tokens)
        n = min(self.prefill_chunk, n_total - done)
        logits, _ = prefill_chunk(self.params, sc,
                                  self._tokens(req.tokens[done:done + n])[None])
        if sc["pos"] < n_total:
            return
        # prompt complete: copy the staged rows into pages, emit a token
        self._to_pages(st["slot"], [(sc["k"][i, 0, :n_total],
                                     sc["v"][i, 0, :n_total])
                                    for i in range(sc["k"].shape[0])])
        req.tokens.append(self._greedy(logits)[0])
        self.slots[st["slot"]] = req
        self.events.append(("prefill", req.prompt_len,
                            self._clock() - st["t0"]))
        self._staging = None

    def step(self) -> int:
        """One engine iteration; returns number of active requests."""
        if self.prefill_chunk:
            self._advance_staged()
        else:
            self._admit()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return 0
        toks = self._tokens([self.slots[i].tokens[-1] for i in active])
        t0 = self._clock()
        cache = {}
        if self.cache is not None:
            for i in active:
                self.cache.extend(i, 1)
            cache.update(self.cache.decode_view(active))
        if self.states is not None:
            cache.update(self.states.decode_view(active))
        logits = decode_step(self.params, toks, cache)
        self.events.append(("decode", len(active), self._clock() - t0))
        for i, nxt in zip(active, self._greedy(logits)):
            req = self.slots[i]
            req.tokens.append(nxt)
            full = len(req.tokens) >= min(
                req.prompt_len + req.max_new_tokens, self.max_len - 1)
            if full or (req.eos_id is not None and nxt == req.eos_id):
                req.done = True
                self.completed.append(req)
                self._free(i)
        return len(active)

    def run_until_drained(self, max_iters: int = 10000):
        for _ in range(max_iters):
            n = self.step()
            if n == 0 and not self.queue and self._staging is None:
                break
        return self.completed
