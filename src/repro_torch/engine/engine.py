"""Per-instance serving engine: continuous batching over the port's model.

Counterpart of ``repro/engine/engine.py:37-216`` with the same surface:
``submit``, ``step``, ``run_until_drained``, ``checkpoint_request``,
``drain_events`` (the black-box timing stream the EMA estimator reads),
``prefill_chunk`` staging with the chunkable-config gate, and a bounded
events deque.  Deliberate differences:

* decode attends over a paged KV cache (``PagedKVCache``) through the paged
  kernel; the JAX engine attends over a dense per-slot ring cache.  Like
  the JAX engine's jitted decode, the step runs at one fixed shape over
  every slot: tokens [max_batch], block tables [max_batch, ceil(max_len /
  page)] and context lengths [max_batch], in device buffers that each step
  rewrites in place (one packed host-to-device copy).  A free slot decodes
  token 0 against the cache's scratch page and its result is dropped.  On
  the card the step is captured once, at construction while every slot is
  free, into a CUDA graph (the counterpart of ``jax.jit``) and replayed on
  every step (``graph_replays`` counts them); a capture or replay that
  fails raises.  On the CPU the same padded step runs eagerly.  The engine
  holds pages only for full attention layers, per-slot K/V rings
  (``WindowCache``, the JAX engine's ring, one stack per ring size; the
  paged kernel reads them through a constant identity table) only for
  window layers, per-slot
  latent rows (``LatentCache``) only for MLA layers and per-slot states
  (``SSMStateCache``) only for mamba layers; decode updates every slot's
  ring rows, latent rows and state in place.  Without a paged cache the
  step's context lengths are each request's token count, 0 in a free row;
* chunked prefill stages into a linear K/V buffer, as the JAX engine does,
  and flash attention sees it cut to ``pos0 + C`` rows.  When the prompt is
  complete the full layers' rows are copied into freshly allocated pages
  and the window layers' last ``min(L, S)`` rows into their rings at ``t
  % S``: what ``ring_convert_cache`` does;
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
* non-finite logits of a request raise ``FloatingPointError`` instead of
  being served;
* under an enabled ``ctx`` (``ShardCtx`` over a ``DeviceMesh``) the engine
  holds the reference's dense ring cache (``init_cache(..., ring=True)``
  placed by ``distributed.sharding.place_cache``) and nothing paged: it
  places a copy of the weights (``placed_copy``; the caller's model stays
  as it is), admits a prompt through ``prefill(ctx=)`` and
  ``to_ring_cache`` or, chunked, ``prefill_chunk(ctx=)`` into one placed
  staging cache and ``ring_convert_cache``, copies it into its slot
  (``splice_ring``, the reference's ``_splice``) and decodes every slot
  through ``ring_decode_step(ctx=)`` at the ring's ``pos``, a view of the
  host buffer's positions (each row's tokens less one, 0 in a free row),
  captured and replayed on the card as the paged step is.  The mesh must
  be on the engine's device;
* ``trace`` (``engine/trace.py``'s ``Tracer``) records the engine's spans
  beside its events: ``queued`` (rid) from ``submit`` to the start of
  admission; ``prefill`` (rid) from there to the first token, the
  ``prefill`` event's dt; under it one ``prefill.call`` (rid, ``tokens``)
  a one-shot prefill or chunk call, a chunk that ends without a
  synchronise closing at the engine's next one (or its next chunk's
  start), and, in a one-shot prefill of a config with mamba layers, one
  ``prefill.state`` (rid, ``bytes``: the conv history and SSM state
  written) around ``SSMStateCache.write``, no synchronise of its own;
  and ``decode`` (``rows``, and ``pages`` in use of the ``pool``
  where the engine has pages) from the ``decode`` event's first clock
  read to the end of its token bookkeeping, tiled by ``decode.fill``
  (``cache.extend``, ``_fill_inputs``), ``decode.launch`` (the replay),
  ``decode.wait`` (the synchronise that ends the event) and
  ``decode.readback`` (``tolist``, tokens, finishing).  Spans take the
  events' clock reads and the synchronises the engine already makes, and
  add none.

The kernel wrappers count launches in Python, which a graph replay does
not run: the counts made while warming up and capturing are taken back, and
each replay adds the launches that the capture recorded.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, synchronize
from repro_torch.distributed.context import (NULL_CTX, ShardCtx, _is_dtensor,
                                            local_rows)
from repro_torch.distributed import sharding as shd
from repro_torch.engine.kv_cache import PagedKVCache
from repro_torch.engine.latent_cache import LatentCache
from repro_torch.engine.state_cache import SSMStateCache
from repro_torch.engine.trace import Span, Tracer
from repro_torch.engine.window_cache import WindowCache
from repro_torch.kernels.decode_fused.ops import (act_mul, add_rms_norm,
                                                  rope_kv_prefill,
                                                  rope_kv_write)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.ssd.ops import ssd
from repro_torch.models.model import (Model, decode_step, init_cache,
                                      init_params, layer_caches, prefill,
                                      prefill_chunk, ring_convert_cache,
                                      ring_decode_step, splice_ring,
                                      to_ring_cache)

# the kernel wrappers the engine runs; a graph replay adds to each one's
# ``launches`` what its capture recorded (none for ``rope_kv_prefill``,
# which runs in prefill only)
KERNELS = (paged_attention, flash_attention, ssd, add_rms_norm, rope_kv_write,
           rope_kv_prefill, act_mul)
WARMUP_STEPS = 2        # eager decode steps on a side stream before capture


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
    cache (full attention layers), one per-slot ring cache (window
    layers), one per-slot latent cache (MLA layers) and one per-slot state
    cache (mamba layers); under a mesh (``ctx``), over the reference's
    ring cache alone."""

    def __init__(self, cfg: ModelConfig, params: Optional[Model] = None, *,
                 max_batch: int = 8, max_len: int = 256,
                 ctx: ShardCtx = NULL_CTX, seed: int = 0,
                 prefill_chunk: Optional[int] = None, max_events: int = 4096,
                 dtype=torch.float32, page_size: int = 16,
                 num_pages: Optional[int] = None, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.ctx = ctx
        self.max_batch = max_batch
        self.max_len = max_len
        if ctx.enabled and ctx.mesh.device_type != self.device.type:
            raise ValueError(f"mesh on {ctx.mesh.device_type}, engine on "
                             f"{self.device}")
        if params is None:
            params = init_params(cfg, seed=seed, dtype=dtype,
                                 device=self.device)
        elif params.device.type != self.device.type:
            raise ValueError(f"weights on {params.device}, engine on "
                             f"{self.device}")
        if ctx.enabled and not _is_dtensor(params.top["embed"]):
            params = shd.placed_copy(params, ctx)
        self.params = params
        self._layer_caches = layer_caches(cfg)
        kinds = {kind for kind, _ in self._layer_caches}
        if ctx.enabled:         # the reference's ring, nothing paged
            kinds = set()
            self.ring = shd.place_cache(
                init_cache(cfg, max_batch, max_len, dtype=params.dtype,
                           device=self.device, ring=True), cfg, ctx, max_len)
        if num_pages is None:
            num_pages = max_batch * -(-max_len // page_size)
        self.cache = (PagedKVCache(cfg, num_pages, page_size,
                                   slots=max_batch, max_len=max_len,
                                   dtype=params.dtype, device=self.device)
                      if "kv" in kinds else None)
        self.window = (WindowCache(cfg, max_batch, max_len, page_size,
                                   dtype=params.dtype, device=self.device)
                       if "win" in kinds else None)
        self.latent = (LatentCache(cfg, max_batch, max_len, dtype=params.dtype,
                                   device=self.device)
                       if "mla" in kinds else None)
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
        if ctx.enabled and self._stage_cache is not None:
            self._stage_cache = shd.place_staging(self._stage_cache, cfg, ctx)
        self._staging: Optional[dict] = None
        self.events: Deque[tuple] = deque(maxlen=max_events)
        self.trace = Tracer()
        self._queued: Dict[int, Span] = {}     # rid: its open ``queued`` span
        self.completed: List[EngineRequest] = []
        self.graph_replays = 0
        self.capture_s: Optional[float] = None
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._init_decode_inputs()
        if self.device.type == "cuda":
            self._capture()

    # -- the fixed-shape decode step ------------------------------------------

    def _init_decode_inputs(self):
        """One packed int32 buffer on the host (pinned on the card) and its
        device copy: tokens [B], then with attention or MLA layers (or a
        mesh) context lengths [B], then with full attention layers block
        tables [B, W]; the step's cache view reads the device copy.  Under
        a mesh the step reads DTensor views of it, made here once: tokens
        [B, 1] with the batch over the data axes and positions [B]
        replicated, as ``place_batch`` and ``place_cache`` place them."""
        B = self.max_batch
        n = B
        if (self.cache is not None or self.window is not None
                or self.latent is not None or self.ctx.enabled):
            n += B
        if self.cache is not None:
            table, _ = self.cache.table_view()
            n += table.size
        self._host = torch.zeros(n, dtype=torch.int32,
                                 pin_memory=self.device.type == "cuda")
        self._dev = torch.zeros(n, dtype=torch.int32, device=self.device)
        self._view = {}
        if n > B:
            self._view["context_lens"] = self._dev[B:2 * B]
        if self.cache is not None:
            self._view.update({"k_pages": self.cache.k_pages,
                               "v_pages": self.cache.v_pages,
                               "block_tables": self._dev[2 * B:].view(B, -1)})
        if self.window is not None:
            self._view.update(self.window.decode_view())
        if self.latent is not None:
            self._view.update(self.latent.decode_view())
        if self.states is not None:
            self._view.update(self.states.decode_view())
        if self.ctx.enabled:
            self._ring_inputs()
        self._fill_inputs([])

    def _ring_inputs(self):
        """DTensor views of the device buffer, made once: the step's tokens
        [B, 1], the batch over the data axes, and the ring's ``pos`` [B],
        replicated, which so is the buffer's positions (``splice_ring``
        writes a slot's there, ``_fill_inputs`` every step's)."""
        from torch.distributed.tensor import DTensor
        B, mesh = self.max_batch, self.ctx.mesh
        tok = self._dev[:B].view(B, 1)
        tok_pl = shd.placements(
            shd.input_sharding(mesh, B, self.ctx.data_axes), mesh)
        first, n = local_rows(mesh, tok_pl, B)
        self._tokens_dt = DTensor.from_local(tok[first:first + n], mesh,
                                             tok_pl, run_check=False)
        self.ring["pos"] = DTensor.from_local(
            self._dev[B:2 * B], mesh, shd.placements((None,), mesh),
            run_check=False)

    def _fill_inputs(self, active: List[int]):
        """Write the step's tokens (0 in free rows), context lengths (the
        paged cache's; without one, each request's tokens and 0 in free
        rows) and the table rows that changed into the host buffer, then
        copy the parts that changed to the device in one copy."""
        B = self.max_batch
        h = self._host.numpy()
        h[:B] = 0
        for i in active:
            h[i] = self.slots[i].tokens[-1]
        n = B
        if self.cache is not None:
            table, lens = self.cache.table_view()
            h[B:2 * B] = lens
            n = 2 * B
            rows = self.cache.take_changed_rows()
            if rows:
                h[2 * B:].reshape(B, -1)[rows] = table[rows]
                n = h.size
        elif self.window is not None or self.latent is not None:
            h[B:2 * B] = 0
            for i in active:
                h[B + i] = len(self.slots[i].tokens)
            n = 2 * B
        elif self.ctx.enabled:       # each row's position, 0 in a free row
            h[B:2 * B] = 0
            for i in active:
                h[B + i] = len(self.slots[i].tokens) - 1
            n = 2 * B
        self._dev[:n].copy_(self._host[:n], non_blocking=True)

    def _step_logits(self) -> torch.Tensor:
        """The step's logits [B, V] over every slot: the paged
        ``decode_step``, or under a mesh ``ring_decode_step`` over the
        placed ring at its ``pos``, the buffer's positions (the step's
        rebinding of ``pos`` lands in a copy of the dict), gathered
        whole."""
        if not self.ctx.enabled:
            return decode_step(self.params, self._dev[:self.max_batch],
                               self._view)
        logits, _ = ring_decode_step(self.params, self._tokens_dt,
                                     dict(self.ring), self.ctx)
        return shd.full(logits)

    def _decode_body(self) -> torch.Tensor:
        """The step over every slot: [2, B] int32, each row's greedy token
        and whether its logits are all finite."""
        logits = self._step_logits()
        return torch.stack([logits.argmax(dim=-1).int(),
                            torch.isfinite(logits).all(dim=-1).int()])

    def _capture(self):
        """Warm the step up on a side stream, then capture it into a CUDA
        graph.  Every slot is free here, so these steps write only the
        scratch page, row 0 of free rings and latent rows, and free mamba
        slots.  The kernel launch counts are left as they were;
        ``_graph_launches`` keeps what one replay launches."""
        t0 = time.perf_counter()
        before = [k.launches for k in KERNELS]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self._decode_body()
        torch.cuda.current_stream(self.device).wait_stream(side)
        mark = [k.launches for k in KERNELS]
        self._graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self._graph):
            self._graph_out = self._decode_body()
        self._graph_launches = [k.launches - m for k, m in zip(KERNELS, mark)]
        for k, b in zip(KERNELS, before):
            k.launches = b
        synchronize(self.device)
        self.capture_s = time.perf_counter() - t0

    def _run_decode(self) -> torch.Tensor:
        if self._graph is None:
            return self._decode_body()
        self._graph.replay()
        self.graph_replays += 1
        for k, n in zip(KERNELS, self._graph_launches):
            k.launches += n
        return self._graph_out

    # -- request lifecycle -----------------------------------------------------

    def submit(self, req: EngineRequest):
        if not 0 < len(req.tokens) < self.max_len:
            raise ValueError(f"request {req.rid}: {len(req.tokens)} tokens, "
                             f"engine holds 1..{self.max_len - 1}")
        self.queue.append(req)
        self._queued[req.rid] = self.trace.open(
            "queued", time.perf_counter(), req.rid, note=False)

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
                self._queued.pop(rid, None)     # never admitted here
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

    def _start_prefill(self, req: EngineRequest, t0: float) -> Span:
        """Close ``req``'s ``queued`` span and open its ``prefill`` at t0,
        the start of its admission."""
        queued = self._queued.pop(req.rid, None)
        if queued is not None:
            self.trace.close(queued, t0)
        return self.trace.open("prefill", t0, req.rid, note=False)

    def _admit(self):
        for i in range(self.max_batch):
            if self.slots[i] is None and self.queue:
                req = self.queue.pop(0)
                t0 = self._clock()
                span = self._start_prefill(req, t0)
                call = self.trace.open("prefill.call", t0, req.rid, span)
                n = len(req.tokens)
                self._prefill_into_slot(i, req, call)
                t1 = self._clock()
                self.trace.close(call, t1, tokens=n)
                self.trace.close(span, t1)
                self.events.append(("prefill", req.prompt_len, t1 - t0))

    def _prefill_into_slot(self, slot: int, req: EngineRequest,
                           call: Optional[Span] = None):
        """Prefill ``req`` in one shot into ``slot``; ``call``, its
        ``prefill.call`` span, holds the ``prefill.state`` span of the
        mamba states' write."""
        if self.ctx.enabled:
            logits, states = prefill(
                self.params, shd.place_batch(self._tokens(req.tokens)[None],
                                            self.ctx), ctx=self.ctx)
            splice_ring(self.ring, to_ring_cache(self.cfg, states,
                                                 self.max_len,
                                                 len(req.tokens)), slot)
            req.tokens.append(self._greedy(shd.full(logits))[0])
            self.slots[slot] = req
            return
        logits, states = prefill(self.params, self._tokens(req.tokens)[None])
        self._write_states(slot, states, req.rid, call)
        req.tokens.append(self._greedy(logits)[0])
        self.slots[slot] = req

    def _write_states(self, slot: int, states: list, rid: int,
                      call: Optional[Span] = None):
        """Write one request's decode states into ``slot``: one state per
        layer, in ``layer_caches`` order, each leaf with a batch dim of 1
        (``prefill``'s), split by cache kind in one pass.  Full attention
        rows go into fresh pages, window rows into the slot's rings, latent
        rows into its latent slot and mamba states into its state slot,
        that write under a ``prefill.state`` span in ``call``."""
        by_kind = {"kv": [], "win": [], "mla": [], "ssm": []}
        for (kind, _), (a, b) in zip(self._layer_caches, states):
            a = {k: v[0] for k, v in a.items()} if kind == "ssm" else a[0]
            by_kind[kind].append((a, b[0]))
        if self.cache is not None:
            self._to_pages(slot, by_kind["kv"])
        if self.window is not None:
            self.window.write(slot, by_kind["win"])
        if self.latent is not None:
            self.latent.write(slot, by_kind["mla"])
        if self.states is not None:
            span = self.trace.open("prefill.state", time.perf_counter(), rid,
                                   call)
            self.states.write(slot, by_kind["ssm"])
            self.trace.close(span, time.perf_counter(),
                             bytes=self.states.slot_bytes)

    def _advance_staged(self):
        """Begin and/or advance the staged prefill by at most one chunk —
        the per-iteration prefill-token budget."""
        if self._staging is None:
            free = next((i for i, r in enumerate(self.slots) if r is None),
                        None)
            if free is None or not self.queue:
                return
            req, t_open = self.queue.pop(0), self._clock()
            self._staging = {"slot": free, "req": req, "t0": t_open,
                             "span": self._start_prefill(req, t_open),
                             "call": None}
            self._stage_cache["pos"] = 0
        else:
            t_open = time.perf_counter()
        st, sc = self._staging, self._stage_cache
        req, done = st["req"], sc["pos"]
        n_total = len(req.tokens)
        n = min(self.prefill_chunk, n_total - done)
        self._settle_chunk(t_open)
        st["call"] = self.trace.open("prefill.call", t_open, req.rid,
                                     st["span"])
        st["n"] = n
        chunk = self._tokens(req.tokens[done:done + n])[None]
        if self.ctx.enabled:
            chunk = shd.place_batch(chunk, self.ctx)
        logits, _ = prefill_chunk(self.params, sc, chunk, self.ctx)
        if sc["pos"] < n_total:
            # no synchronise here: the call's span ends at the engine's
            # next one, or where its next chunk opens
            self.trace.end_note(st["call"])
            return
        # prompt complete: copy the staged rows into pages and rings (under
        # a mesh: into the slot's row of the ring cache), emit a token
        if self.ctx.enabled:
            splice_ring(self.ring, ring_convert_cache(
                self.cfg, sc, self.max_len, n_total), st["slot"])
            self._finish_staged(shd.full(logits))
            return
        self._write_states(st["slot"], [(k[:, :n_total], v[:, :n_total])
                                        for k, v in zip(sc["k"], sc["v"])],
                           req.rid, st["call"])
        self._finish_staged(logits)

    def _finish_staged(self, logits):
        st = self._staging
        req = st["req"]
        req.tokens.append(self._greedy(logits)[0])
        self.slots[st["slot"]] = req
        t1 = self._clock()
        self.trace.close(st["call"], t1, tokens=st["n"])
        self.trace.close(st["span"], t1)
        self.events.append(("prefill", req.prompt_len, t1 - st["t0"]))
        self._staging = None

    def _settle_chunk(self, t: float):
        """End the span of a chunk call that had no synchronise of its own
        at ``t``: the engine's next synchronise, or its next chunk's
        start."""
        st = self._staging
        if st is not None and st["call"] is not None:
            self.trace.close(st["call"], t, tokens=st["n"])
            st["call"] = None

    def step(self) -> int:
        """One engine iteration; returns number of active requests."""
        if self.prefill_chunk:
            self._advance_staged()
        else:
            self._admit()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return 0
        t0 = self._clock()
        tr = self.trace
        self._settle_chunk(t0)
        tr.sample_clock()
        span = tr.open("decode", t0)
        tr.next_child(span, "decode.fill", t0)
        if self.cache is not None:
            for i in active:
                self.cache.extend(i, 1)
        self._fill_inputs(active)
        pages = {} if self.cache is None else {
            "pages": self.cache.num_pages - len(self.cache.free),
            "pool": self.cache.num_pages}
        tr.next_child(span, "decode.launch", time.perf_counter())
        out = self._run_decode()
        tr.next_child(span, "decode.wait", time.perf_counter())
        t1 = self._clock()
        self.events.append(("decode", len(active), t1 - t0))
        tr.next_child(span, "decode.readback", t1)
        tokens, finite = out.tolist()
        if not all(finite[i] for i in active):
            raise FloatingPointError("non-finite logits")
        for i in active:
            req, nxt = self.slots[i], tokens[i]
            req.tokens.append(nxt)
            full = len(req.tokens) >= min(
                req.prompt_len + req.max_new_tokens, self.max_len - 1)
            if full or (req.eos_id is not None and nxt == req.eos_id):
                req.done = True
                self.completed.append(req)
                self._free(i)
        tr.close(span, time.perf_counter(), rows=len(active), **pages)
        return len(active)

    def run_until_drained(self, max_iters: int = 10000):
        for _ in range(max_iters):
            n = self.step()
            if n == 0 and not self.queue and self._staging is None:
                break
        return self.completed
