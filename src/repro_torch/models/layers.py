"""Layers of the decoder: RMSNorm, RoPE, GQA attention, MLA, gated FFN, MoE.

Counterparts of ``repro/models/layers.py``: ``rms_norm`` (:27-31) with its
``(1 + w)`` scale, the half-split ``rope`` (:38-48), ``init_attention`` and
``_qkv`` with optional qk_norm and its sharding constraints (:59-116),
``_sdpa`` (:119-132), ``attn_forward`` (:175-183), ``attn_decode``
(:186-207; ``ring_attn_decode`` over the dense ring), ``attn_chunk``
(:210-238), ``init_mla``, ``_mla_q_and_latent``, ``mla_forward`` and
``mla_decode`` (:245-356), ``init_ffn`` and ``ffn_forward`` (:363-381),
``init_moe``, ``moe_capacity``, ``_moe_local`` and both branches of
``moe_forward`` (:388-535): the plain one, and the ``shard_map`` one as a
``local_map`` over the mesh of a ``ShardCtx``.

With an active ``ShardCtx`` the parameters and activations are DTensors
(``distributed/sharding.py``) and ``ctx.constraint`` redistributes them
where the reference constrains them.  Attention runs inside ``local_map``
on each rank's shard (the flash kernel, or in training the plain
``_sdpa_chunked``): the batch over the data axes and whole heads over the
model axis (K/V regathered to whole heads where the reference would shard
them by sequence or head_dim; a rank hands the kernel only the KV heads
its own query heads read); so does the MoE dispatch, with the tokens on
their (pod, data) shard and the expert FF dim over the model axis, the
down-projection summed over it.

Attention goes through the kernel wrappers: ``attn_forward`` and
``attn_chunk`` through ``flash_attention`` (full and window layers), and
``attn_decode`` through ``paged_attention`` over the engine's paged cache
(the JAX layer attends over a dense per-slot ring) or over a window
layer's per-slot ring, laid out as whole pages of its slot (the JAX
layer's ring with a masked ``_sdpa``).  The model's two serving layer
loops (``models/model.py``) call two sets of layers.  The fused loop
(``_fused_layers``: the decode step, and prefill and its chunks outside a
mesh) forms each block's normed input with ``add_rms_norm`` and calls the
layers that start past the norm, whose glue goes through the fused
kernels of ``kernels/decode_fused``: ``attn_decode`` (one token;
``rope_kv_write`` rotates q and k and writes the new K/V), ``attn_prefill``
(a prompt's or chunk's rows; ``rope_kv_prefill``, then the flash kernel)
and ``ffn_decode`` (``act_mul``).  The plain loop (``_plain_layers``: a
mesh, meta tensors, the ring decode) calls the layers that take their
own norm: ``attn_forward``, ``attn_chunk``, ``ring_attn_decode`` and
``ffn_forward``.  MLA, mamba and the MoE FFN take their own norm on
both.  ``_sdpa``,
``rms_norm`` and ``rope`` stay as the plain references the tests compare
the layers and kernels against.  A config with ``position_embedding``
"nope" rotates nothing on any path, and its ``attention_multiplier``
(where set) scales the scores of ``_sdpa`` and of both kernels in place
of head_dim ** -0.5; ``residual_add`` is the residual add with the
config's ``residual_multiplier``.  Training goes around the kernels, which
run forward only and refuse inputs that require grad:
``attn_forward(..., train=True)`` attends through ``_sdpa_chunked``
(:135-161), plain einsums over 512-row query chunks, each
rematerialised, as the reference trains (:182).  MLA
and the MoE FFN run no kernel in
the JAX package and none here: they are plain torch ops, and their decode
paths read nothing on the host, so the engine's decode graph captures
them.  Parameters are ``nn.ParameterDict``s
keyed like the JAX pytree, frozen (no gradients) until a trainer turns
their gradients on (``training/train_step.py``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.context import (NULL_CTX, ShardCtx, _is_dtensor,
                                            contiguous_grads, replicated_like)
from repro_torch.distributed.sharding import placements
from repro_torch.kernels.decode_fused.ops import (act_mul, rope_kv_prefill,
                                                  rope_kv_write)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.paged_attention.ops import paged_attention


def rms_norm(x, w, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def block_input(x, w, cfg: ModelConfig, ctx: ShardCtx = NULL_CTX):
    """``rms_norm`` of the residual stream x [B, L, d] at a block's input,
    under a mesh with its tokens gathered whole: the sequence-parallel
    residual re-gathers before the block's projections (a matmul cannot
    flatten a sharded token dim into its rows)."""
    h = rms_norm(x, w, cfg.norm_eps)
    return ctx.constraint(h, ctx.batch_spec_entry(x.shape[0]), None, None)


def residual_add(x, y, alpha: float = 1.0):
    """x + alpha * y: ``x + y`` where alpha is 1, else formed in float32
    and rounded once to x's dtype, as ``add_rms_norm`` forms it."""
    if alpha == 1.0:
        return x + y
    return (x.float() + y.float() * alpha).to(x.dtype)


def _act(name: str):
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")   # jax.nn.gelu default
    return F.silu


def rope_freqs(hd: int, theta: float, device):
    """RoPE's frequencies [hd / 2]: theta^(-i / (hd / 2)) in fp32."""
    half = hd // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def rope(x, positions, theta: float):
    """Rotary embedding.  x: [..., L, H, hd]; positions: [..., L]."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * freqs               # [..., L, half]
    cos = replicated_like(torch.cos(ang)[..., None, :], x)   # [..., L, 1, half]
    sin = replicated_like(torch.sin(ang)[..., None, :], x)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def frozen(tensors: dict) -> nn.ParameterDict:
    return nn.ParameterDict(
        {k: nn.Parameter(v, requires_grad=False) for k, v in tensors.items()})


class MetaGenerator:
    """Stands in for a generator on the meta device, which has none: the
    init functions then draw shapes only (the dry run's parameters)."""
    device = torch.device("meta")


def generator_of(gen):
    """``gen``, or None for a ``MetaGenerator``."""
    return None if isinstance(gen, MetaGenerator) else gen


def _normal(gen: torch.Generator, shape, std: float, dtype):
    return (torch.randn(shape, generator=generator_of(gen),
                        dtype=torch.float32, device=gen.device) * std).to(dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def init_attention(cfg: ModelConfig, gen: torch.Generator, dtype):
    d, qd, kvd = cfg.d_model, cfg.attn_q_dim, cfg.attn_kv_dim
    std = d ** -0.5
    p = {
        "ln": torch.zeros((d,), dtype=dtype, device=gen.device),
        "wq": _normal(gen, (d, qd), std, dtype),
        "wk": _normal(gen, (d, kvd), std, dtype),
        "wv": _normal(gen, (d, kvd), std, dtype),
        "wo": _normal(gen, (qd, d), qd ** -0.5, dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((cfg.head_dim,), dtype=dtype, device=gen.device)
        p["k_norm"] = torch.zeros((cfg.head_dim,), dtype=dtype, device=gen.device)
    return frozen(p)


def _qkv(p, cfg: ModelConfig, x, positions, ctx: ShardCtx = NULL_CTX,
         decode: bool = False):
    B, L, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = split_heads(x @ p["wq"], H, ctx)
    k = split_heads(x @ p["wk"], KV, ctx)
    v = split_heads(x @ p["wv"], KV, ctx)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.rotary:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    bspec = ctx.batch_spec_entry(B)
    kv_tp = ctx.enabled and KV % ctx.tp_size == 0
    if decode:
        # KV heads that do not divide the model axis: replicate the
        # one-token q, the cache being sharded on sequence
        q = ctx.constraint(q, bspec, None, ctx.model_axis if kv_tp else None,
                           None)
        return q, k, v
    if ctx.enabled:
        # heads that do not divide: replicate q and shard K/V on sequence
        q = ctx.constraint(q, bspec, None, ctx.model_axis_if_divides(H), None)
        if kv_tp:
            k = ctx.constraint(k, bspec, None, ctx.model_axis, None)
            v = ctx.constraint(v, bspec, None, ctx.model_axis, None)
        else:
            seq = ctx.model_axis if L % ctx.tp_size == 0 else None
            k = ctx.constraint(k, bspec, seq, None, None)
            v = ctx.constraint(v, bspec, seq, None, None)
    return q, k, v


def split_heads(t, n: int, ctx: ShardCtx = NULL_CTX):
    """[B, L, n * hd] -> [B, L, n, hd].  A DTensor whose n heads do not
    divide the model axis is first gathered over it: its shards need not
    end on a head."""
    if ctx.enabled and n % ctx.tp_size and _is_dtensor(t):
        t = ctx.constraint(t, ctx.batch_spec_entry(t.shape[0]), None, None)
    return t.reshape(*t.shape[:-1], n, t.shape[-1] // n)


def _sdpa(q, k, v, mask, softcap: Optional[float] = None,
          scale: Optional[float] = None):
    """Plain reference.  q: [B,Lq,H,hd], k/v: [B,Lk,KV,hd], mask:
    [B or 1, Lq, Lk] bool -> [B, Lq, H*hd].  Scores scaled by ``scale``,
    or hd ** -0.5 where it is None."""
    B, Lq, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Lq, KV, H // KV, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k).float() \
        * (hd ** -0.5 if scale is None else scale)
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    mask = replicated_like(mask, scores)
    scores = scores.masked_fill(~mask[:, None, None], -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(B, Lq, H * hd)


def causal_mask(Lq: int, Lk: int, window: Optional[int] = None,
                offset: int = 0, device=None):
    """[1, Lq, Lk] bool.  offset = number of earlier tokens already in k."""
    qi = torch.arange(Lq, device=device)[:, None] + offset
    ki = torch.arange(Lk, device=device)[None, :]
    m = ki <= qi
    if window is not None:
        m &= ki > qi - window
    return m[None]


def _sdpa_rows(q, k, v, off: int, window: Optional[int],
               softcap: Optional[float], scale: Optional[float] = None):
    """``_sdpa`` of the query rows ``off .. off + len(q)`` over every key."""
    mask = causal_mask(q.shape[1], k.shape[1], window, off, q.device)
    return _sdpa(q, k, v, mask, softcap, scale)


def _sdpa_chunked(q, k, v, window: Optional[int], softcap: Optional[float],
                  chunk: int = 512, scale: Optional[float] = None):
    """Causal ``_sdpa`` over query chunks, so scores take [B, H, chunk, Lk]
    at most; each chunk's body is rematerialised, so the backward pass
    recomputes its scores instead of holding every chunk's probabilities.
    Plain and differentiable: the training path.  Above ``chunk`` rows Lq
    must be a multiple of it, as the reference asserts."""
    Lq = q.shape[1]
    if Lq <= chunk:
        return _sdpa(q, k, v, causal_mask(Lq, Lq, window, device=q.device),
                     softcap, scale)
    if Lq % chunk:
        raise ValueError(f"{Lq} query rows are not a multiple of the "
                         f"{chunk}-row chunk")
    outs = [checkpoint(_sdpa_rows, q[:, off:off + chunk], k, v, off, window,
                       softcap, scale, use_reentrant=False)
            for off in range(0, Lq, chunk)]
    return torch.cat(outs, dim=1)


def attn_forward(p, cfg: ModelConfig, x, positions, window: Optional[int],
                 ctx: ShardCtx = NULL_CTX, train: bool = False):
    """Full-sequence causal attention: through the flash kernel (prefill),
    or with ``train`` through the plain, differentiable ``_sdpa_chunked``;
    under a mesh either runs inside ``local_map``.  Returns (y, (k, v)) so
    prefill can fill the cache."""
    B, L, _ = x.shape
    h = block_input(x, p["ln"], cfg, ctx)
    q, k, v = _qkv(p, cfg, h, positions, ctx)
    scale = cfg.attention_multiplier
    if ctx.enabled and _is_dtensor(q):
        y = _attend_sharded(q, k, v, window, cfg.logit_softcap, ctx, train,
                            scale)
    elif train:
        y = _sdpa_chunked(q, k, v, window, cfg.logit_softcap, scale=scale)
    else:
        y = flash_attention(q, k, v, causal=True, window=window,
                            softcap=cfg.logit_softcap, scale=scale)
    return y.reshape(B, L, -1) @ p["wo"], (k, v)


def attn_prefill(p, cfg: ModelConfig, h, B: int, window: Optional[int],
                 pos0: int = 0, cache_k=None, cache_v=None):
    """A prompt's or chunk's attention through the fused glue: ``attn_forward``
    (no cache) or ``attn_chunk`` (``cache_k``/``cache_v``, the linear
    staging cache [B, S, KV, hd] with S >= pos0 + L) past the block's norm.
    h: the normed input as rows [B * L, d] (the prefill folds the residual
    add into ``add_rms_norm``); row i of a batch at position ``pos0 + i``.
    ``rope_kv_prefill`` takes qk_norm, rotates q and k (not at all under
    NoPE) and, with a cache, stores K/V at ``pos0`` onward; the flash
    kernel then attends over the prompt's own K/V or the cache's first
    ``pos0 + L`` rows.  Returns (y [B * L, d], (k, v) that the flash kernel
    read)."""
    L = h.shape[0] // B
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    v = (h @ p["wv"]).view(B, L, KV, hd)
    outs = () if cache_k is None else (cache_k[:, pos0:pos0 + L],
                                       cache_v[:, pos0:pos0 + L])
    q, k = rope_kv_prefill((h @ p["wq"]).view(B, L, H, hd),
                           (h @ p["wk"]).view(B, L, KV, hd), v, pos0,
                           cfg.rope_theta if cfg.rotary else None,
                           p.get("q_norm"), p.get("k_norm"), cfg.norm_eps,
                           *outs)
    if cache_k is not None:
        k, v = cache_k[:, :pos0 + L], cache_v[:, :pos0 + L]
    y = flash_attention(q, k, v, causal=True, window=window,
                        softcap=cfg.logit_softcap,
                        scale=cfg.attention_multiplier)
    return y.reshape(B * L, -1) @ p["wo"], (k, v)


def local_heads(k, n_heads: int, n_local: int, rank: int):
    """The KV heads (or B/C groups) of k [B, L, KV, ·] that query heads
    ``rank * n_local`` .. ``(rank + 1) * n_local - 1`` of ``n_heads`` read,
    head h reading ``h // (n_heads // KV)``: a slice where the local heads
    cover whole groups or share one, else every head's own copy."""
    G = n_heads // k.shape[2]
    first = rank * n_local
    if n_local % G == 0:
        return k[:, :, first // G:(first + n_local) // G]
    if G % n_local == 0:
        return k[:, :, first // G:first // G + 1]
    return k.repeat_interleave(G, dim=2)[:, :, first:first + n_local]


def head_axes(H: int, KV: int, ctx: ShardCtx):
    """(q's head entry, K/V's head entry) of attention under ``local_map``:
    whole query heads over the model axis where they divide it, the KV
    heads with them where they divide it too, else whole on every rank."""
    q_ax = ctx.model_axis_if_divides(H)
    return q_ax, ctx.model_axis_if_divides(KV) if q_ax else None


def _attend_sharded(q, k, v, window, softcap, ctx: ShardCtx, train: bool,
                    scale: Optional[float] = None):
    """Attention on each rank's shard, under ``local_map``: through
    ``flash_attention``, or with ``train`` the plain ``_sdpa_chunked``
    (whose DTensor einsums would flatten sharded dims).  The batch is over
    the data axes, q's whole heads over the model axis where they divide
    it (else every rank runs all heads), K/V whole heads, sharded with q's
    where the KV heads divide the axis too, else whole on every rank,
    which hands the kernel only the heads its query heads read (and takes
    back each rank's part of their gradients).  Returns [B, L, H * hd]."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    B, _, H, _ = q.shape
    bspec = ctx.batch_spec_entry(B)
    q_ax, kv_ax = head_axes(H, k.shape[2], ctx)
    qp = placements((bspec, None, q_ax, None), ctx.mesh)
    kp = placements((bspec, None, kv_ax, None), ctx.mesh)
    kp_grad = kp
    if q_ax and not kv_ax:
        kp_grad = tuple(Partial() if a == ctx.model_axis else pl
                        for a, pl in zip(ctx.mesh.mesh_dim_names, kp))

    def body(ql, kl, vl):
        ql, kl, vl = contiguous_grads(ql, kl, vl)
        if q_ax and not kv_ax:
            r = ctx.mesh.get_local_rank(ctx.model_axis)
            kl, vl = (local_heads(t, H, ql.shape[2], r) for t in (kl, vl))
        if train:
            return _sdpa_chunked(ql, kl, vl, window, softcap, scale=scale)
        y = flash_attention(ql.contiguous(), kl.contiguous(),
                            vl.contiguous(), causal=True, window=window,
                            softcap=softcap, scale=scale)
        return y.reshape(*y.shape[:2], -1)
    return local_map(body, out_placements=(placements((bspec, None, q_ax),
                                                      ctx.mesh),),
                     in_placements=(qp, kp, kp),
                     in_grad_placements=(qp, kp_grad, kp_grad),
                     device_mesh=ctx.mesh, redistribute_inputs=True)(q, k, v)


def attn_decode(p, cfg: ModelConfig, h, k_pages, v_pages, tables,
                context_lens, size: Optional[int] = None):
    """One-token decode of the block's normed input h [B, 1, d] over the
    engine's paged cache (``size`` None) or, for a window layer, over its
    per-slot ring of ``size`` = min(window, max_len) rows: the JAX
    ``attn_decode`` with the block's norm taken by the caller (the decode
    step folds the residual add into it).  k/v_pages: [P, page, KV, hd] of
    this layer; tables int32 [B, n] name each row's pages (a ring: slot
    b's own pages, n * page >= size); context_lens int32 [B] counts the
    new token.  ``rope_kv_write`` applies qk_norm, rotates q and k, and
    writes the new K/V in place: paged, at position ``context_lens - 1``
    (a free row, of length 1, on the scratch page); in a ring, at row
    ``pos % size``, pos = max(context_lens - 1, 0), so a free row of
    length 0 writes row 0 of its own ring.  The paged kernel then attends
    over the first ``context_lens`` tokens, or ``min(context_lens,
    size)`` ring rows: every row the ring holds once it has wrapped, else
    the positions so far, as JAX's mask ``slot <= pos | pos >= S`` keeps
    (rows hold K after RoPE, so their order does not change the scores);
    the scores capped at ``cfg.logit_softcap`` where the config sets one.
    A NoPE config rotates nothing (``rope_kv_write`` with no theta).  No
    host read."""
    B = h.shape[0]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = rope_kv_write((h @ p["wq"]).view(B, H, hd),
                      (h @ p["wk"]).view(B, KV, hd),
                      (h @ p["wv"]).view(B, KV, hd), context_lens, tables,
                      k_pages, v_pages, cfg.rope_theta if cfg.rotary else None,
                      p.get("q_norm"), p.get("k_norm"), cfg.norm_eps, size)
    lens = context_lens if size is None else context_lens.clamp_max(size)
    y = paged_attention(q, k_pages, v_pages, tables, lens, cfg.logit_softcap,
                        cfg.attention_multiplier)
    return y.reshape(B, 1, -1) @ p["wo"]


def write_rows(cache, new, rows):
    """Row ``rows[b]`` of cache[b] (cache [B, S, ...]) set to new[b], in
    place: one indexed store.  On a DTensor cache whose S is whole on every
    rank, the same store into each rank's own batch rows (``_local_shards``);
    on one whose S is sharded, the reference's masked select (elementwise
    along S)."""
    B, S = cache.shape[:2]
    if _is_dtensor(cache):
        if any(pl.is_shard(1) for pl in cache.placements):
            hit = torch.arange(S, device=rows.device)[None, :] == rows[:, None]
            hit = hit.reshape(B, S, *(1,) * (cache.dim() - 2))
            cache.copy_(torch.where(hit, new[:, None], cache))
            return
        cache, new, rows = _local_shards(cache, new, rows)
        B = cache.shape[0]
    idx = torch.arange(B, device=cache.device) * S + rows
    cache.view(B * S, *cache.shape[2:])[idx] = new


def _local_shards(cache, new, rows):
    """This rank's shards of a DTensor cache [B, S, ...] (S whole), of the
    new rows new [B, ...] placed as the cache's rows are and of the row
    indices rows [B] split as its batch is: (local cache, new, rows)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh, pls = cache.device_mesh, cache.placements
    new_pl = tuple(Shard(pl.dim - 1) if pl.is_shard() and pl.dim > 1 else pl
                   for pl in pls)
    rows_pl = tuple(pl if pl.is_shard(0) else Replicate() for pl in pls)
    new = replicated_like(new, cache).redistribute(mesh, new_pl)
    rows = replicated_like(rows, cache).redistribute(mesh, rows_pl)
    return cache.to_local(), new.to_local(), rows.to_local()


def ring_attn_decode(p, cfg: ModelConfig, x, cache_k, cache_v, pos,
                     window: Optional[int], ctx: ShardCtx = NULL_CTX):
    """One-token decode over a dense ring: the reference's ``attn_decode``.
    x: [B, 1, d]; cache_k/v: [B, S, KV, hd], S = min(window, max_len) for a
    window layer; pos: [B], the new token's position.  Writes the new K/V
    at slot ``pos % S`` in place and attends over the valid slots (all once
    the ring has wrapped) with the plain ``_sdpa``; RoPE is applied before
    the cache, so ring order does not change the scores."""
    S = cache_k.shape[1]
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q, k_new, v_new = _qkv(p, cfg, h, pos[:, None], ctx, decode=True)
    slot = pos % S
    write_rows(cache_k, k_new[:, 0], slot)
    write_rows(cache_v, v_new[:, 0], slot)
    ar = torch.arange(S, device=pos.device)[None, :]
    valid = (ar <= pos[:, None]) | (pos[:, None] >= S)
    if (ctx.enabled and _is_dtensor(cache_k)
            and cfg.num_kv_heads % ctx.tp_size == 0
            and not any(pl.is_shard(1) for pl in cache_k.placements)):
        y = _ring_attend_sharded(q, cache_k, cache_v, valid, cfg.logit_softcap,
                                 ctx, cfg.attention_multiplier)
    else:
        y = _sdpa(q, cache_k, cache_v, valid[:, None, :], cfg.logit_softcap,
                  cfg.attention_multiplier)
    return y @ p["wo"]


def _ring_attend_sharded(q, cache_k, cache_v, valid, softcap, ctx: ShardCtx,
                         scale: Optional[float] = None):
    """``_sdpa`` of one token over the ring on each rank's shard, under
    ``local_map``, where the cache holds whole KV heads over the model axis
    and all of its rows (DTensor's einsum would flatten sharded dims); a
    sequence-sharded cache stays with the DTensor ``_sdpa``, whose softmax
    gathers only the scores."""
    from torch.distributed.tensor.experimental import local_map
    bspec = ctx.batch_spec_entry(q.shape[0])
    M = ctx.model_axis
    return local_map(
        lambda ql, kl, vl, ml: _sdpa(ql, kl, vl, ml[:, None, :], softcap,
                                     scale),
        out_placements=(placements((bspec, None, M), ctx.mesh),),
        in_placements=(placements((bspec, None, M, None), ctx.mesh),
                       cache_k.placements, cache_v.placements,
                       placements((bspec, None), ctx.mesh)),
        device_mesh=ctx.mesh, redistribute_inputs=True)(
            q, cache_k, cache_v, valid)


def attn_chunk(p, cfg: ModelConfig, x, cache_k, cache_v, pos0: int,
               window: Optional[int], ctx: ShardCtx = NULL_CTX):
    """Chunked prefill: extend a LINEAR (slot == position) staging cache by
    the C tokens of x [B, C, d] starting at ``pos0``; cache_k/v:
    [B, S, KV, hd] with S >= pos0 + C, written in place.  Flash attention
    sees K/V cut to ``pos0 + C`` rows, so its tail alignment
    (q_offset = Lk - Lq) puts the chunk's queries at pos0..pos0+C-1.
    Under a mesh both run on each rank's shard (``_chunk_sharded``)."""
    B, C, _ = x.shape
    h = block_input(x, p["ln"], cfg, ctx)
    positions = (pos0 + torch.arange(C, device=x.device))[None].expand(B, C)
    q, k_new, v_new = _qkv(p, cfg, h, positions, ctx)
    if ctx.enabled and _is_dtensor(q):
        y = _chunk_sharded(q, k_new, v_new, cache_k, cache_v, pos0, window,
                           cfg.logit_softcap, ctx, cfg.attention_multiplier)
    else:
        cache_k[:, pos0:pos0 + C] = k_new
        cache_v[:, pos0:pos0 + C] = v_new
        y = flash_attention(q, cache_k[:, :pos0 + C], cache_v[:, :pos0 + C],
                            causal=True, window=window,
                            softcap=cfg.logit_softcap,
                            scale=cfg.attention_multiplier)
    return y.reshape(B, C, -1) @ p["wo"]


def _chunk_sharded(q, k_new, v_new, cache_k, cache_v, pos0: int, window,
                   softcap, ctx: ShardCtx, scale: Optional[float] = None):
    """``attn_chunk``'s write and flash call on each rank's shard, under
    ``local_map``, as ``_attend_sharded`` splits prefill: the batch over
    the data axes, whole heads over the model axis (``head_axes``), a rank
    handing the kernel only the KV heads its query heads read.  The
    staging layer cache_k/v [B, S, KV, hd] must already be placed so
    (``distributed.sharding.place_staging``): each rank writes the chunk's rows
    into its own shard in place.  Returns [B, C, H * hd]."""
    from torch.distributed.tensor.experimental import local_map
    B, C, H, _ = q.shape
    bspec = ctx.batch_spec_entry(B)
    q_ax, kv_ax = head_axes(H, k_new.shape[2], ctx)
    kp = placements((bspec, None, kv_ax, None), ctx.mesh)
    for c in (cache_k, cache_v):
        if not _is_dtensor(c) or tuple(c.placements) != kp:
            raise ValueError(
                f"staging cache placed {getattr(c, 'placements', None)}, "
                f"the chunk step writes {kp}: place it with "
                f"distributed.sharding.place_staging")

    def body(ql, kl, vl, ck, cv):
        ck[:, pos0:pos0 + C] = kl
        cv[:, pos0:pos0 + C] = vl
        kc, vc = ck[:, :pos0 + C], cv[:, :pos0 + C]
        if q_ax and not kv_ax:
            r = ctx.mesh.get_local_rank(ctx.model_axis)
            kc, vc = (local_heads(t, H, ql.shape[2], r).contiguous()
                      for t in (kc, vc))
        y = flash_attention(ql.contiguous(), kc, vc, causal=True,
                            window=window, softcap=softcap, scale=scale)
        return y.reshape(*y.shape[:2], -1)
    return local_map(body, out_placements=(placements((bspec, None, q_ax),
                                                      ctx.mesh),),
                     in_placements=(placements((bspec, None, q_ax, None),
                                               ctx.mesh), kp, kp, kp, kp),
                     device_mesh=ctx.mesh, redistribute_inputs=True)(
                         q, k_new, v_new, cache_k, cache_v)


# ---------------------------------------------------------------------------
# Dense gated FFN
# ---------------------------------------------------------------------------

def init_ffn(cfg: ModelConfig, gen: torch.Generator, dtype,
             d_ff: Optional[int] = None):
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    return frozen({
        "ln": torch.zeros((d,), dtype=dtype, device=gen.device),
        "w_gate": _normal(gen, (d, ff), d ** -0.5, dtype),
        "w_up": _normal(gen, (d, ff), d ** -0.5, dtype),
        "w_down": _normal(gen, (ff, d), ff ** -0.5, dtype),
    })


def ffn_forward(p, cfg: ModelConfig, x, ctx: ShardCtx = NULL_CTX):
    h = block_input(x, p["ln"], cfg, ctx)
    z = _act(cfg.act)(h @ p["w_gate"]) * (h @ p["w_up"])
    z = ctx.constraint(z, ctx.batch_spec_entry(x.shape[0]), None,
                       ctx.model_axis_if_divides(z.shape[-1]))
    return z @ p["w_down"]


def ffn_decode(p, cfg: ModelConfig, h):
    """The dense FFN of the block's normed input h (the decode step and the
    fused prefill take the norm, with the residual add folded in):
    ``ffn_forward`` past its norm, ``act(g) * u`` in one ``act_mul``."""
    return act_mul(h @ p["w_gate"], h @ p["w_up"], cfg.act) @ p["w_down"]


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------

def init_mla(cfg: ModelConfig, gen: torch.Generator, dtype):
    m = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    std = d ** -0.5
    return frozen({
        "ln": torch.zeros((d,), dtype=dtype, device=gen.device),
        "wq": _normal(gen, (d, H * (m.nope_head_dim + m.rope_head_dim)), std,
                      dtype),
        "w_dkv": _normal(gen, (d, m.kv_lora_rank + m.rope_head_dim), std,
                         dtype),
        "kv_norm": torch.zeros((m.kv_lora_rank,), dtype=dtype,
                               device=gen.device),
        "w_uk": _normal(gen, (m.kv_lora_rank, H * m.nope_head_dim),
                        m.kv_lora_rank ** -0.5, dtype),
        "w_uv": _normal(gen, (m.kv_lora_rank, H * m.v_head_dim),
                        m.kv_lora_rank ** -0.5, dtype),
        "wo": _normal(gen, (H * m.v_head_dim, d), (H * m.v_head_dim) ** -0.5,
                      dtype),
    })


def _mla_q_and_latent(p, cfg: ModelConfig, h, positions,
                      ctx: ShardCtx = NULL_CTX):
    m = cfg.mla
    B, L, _ = h.shape
    q = split_heads(h @ p["wq"], cfg.num_heads, ctx)
    q_nope, q_rope = q.split([m.nope_head_dim, m.rope_head_dim], dim=-1)
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    c_kv, k_rope = (h @ p["w_dkv"]).split([m.kv_lora_rank, m.rope_head_dim],
                                          dim=-1)
    c_kv = rms_norm(c_kv, p["kv_norm"], cfg.norm_eps)
    k_rope = rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, c_kv, k_rope


def mla_forward(p, cfg: ModelConfig, x, positions, ctx: ShardCtx = NULL_CTX,
                chunk: int = 512):
    """Full-sequence MLA (expanded form) over query chunks of ``chunk``, so
    the scores take [B, H, chunk, L] at most.  Any L: the last chunk may be
    short (the JAX layer asserts L % 512 == 0 above 512).  Returns (y,
    (c_kv [B, L, kv_lora], k_rope [B, L, rope])) for the latent cache."""
    m = cfg.mla
    B, L, _ = x.shape
    H = cfg.num_heads
    h = block_input(x, p["ln"], cfg, ctx)
    q_nope, q_rope, c_kv, k_rope = _mla_q_and_latent(p, cfg, h, positions,
                                                     ctx)
    k_nope = split_heads(c_kv @ p["w_uk"], H, ctx)
    v = split_heads(c_kv @ p["w_uv"], H, ctx)
    scale = (m.nope_head_dim + m.rope_head_dim) ** -0.5
    bspec = ctx.batch_spec_entry(B)
    hspec = ctx.heads_spec(H, m.nope_head_dim)
    if hspec is not None:
        q_nope = ctx.constraint(q_nope, bspec, None, *hspec)
        k_nope = ctx.constraint(k_nope, bspec, None, *hspec)
        v = ctx.constraint(v, bspec, None, *hspec)
    args = (q_nope, q_rope, k_nope, k_rope, v, scale, chunk)
    if hspec == (ctx.model_axis, None) and _is_dtensor(q_nope):
        y = _mla_attend_sharded(*args, ctx)
    else:
        y = _mla_attend(*args)
    return y.reshape(B, L, -1) @ p["wo"], (c_kv, k_rope)


def _mla_attend(q_nope, q_rope, k_nope, k_rope, v, scale: float, chunk: int):
    """MLA's causal attention over query chunks: [B, L, H * v_head]."""
    B, L, H, _ = q_nope.shape
    ys = []
    for q0 in range(0, L, chunk):
        qn, qr = q_nope[:, q0:q0 + chunk], q_rope[:, q0:q0 + chunk]
        scores = (torch.einsum("bqhd,bshd->bhqs", qn, k_nope)
                  + torch.einsum("bqhd,bsd->bhqs", qr, k_rope)
                  ).float() * scale
        mask = replicated_like(
            causal_mask(qn.shape[1], L, offset=q0, device=qn.device), qn)
        scores = scores.masked_fill(~mask[:, None], -1e30)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        ys.append(torch.einsum("bhqs,bshd->bqhd", probs, v))
    return torch.cat(ys, dim=1).reshape(B, L, -1)


def _mla_attend_sharded(q_nope, q_rope, k_nope, k_rope, v, scale: float,
                        chunk: int, ctx: ShardCtx):
    """``_mla_attend`` on each rank's whole heads, under ``local_map``
    (DTensor's einsums would flatten sharded dims); k_rope, which every
    head reads, is whole on each rank and takes back each rank's part of
    its gradient."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    bspec = ctx.batch_spec_entry(q_nope.shape[0])
    M = ctx.model_axis
    heads = placements((bspec, None, M, None), ctx.mesh)
    kr = placements((bspec, None, None), ctx.mesh)
    kr_grad = tuple(Partial() if a == M else pl
                    for a, pl in zip(ctx.mesh.mesh_dim_names, kr))

    def body(qn, qr, kn, kr_, v_):
        return _mla_attend(*contiguous_grads(qn, qr, kn, kr_, v_), scale,
                           chunk)
    return local_map(
        body, out_placements=(placements((bspec, None, M), ctx.mesh),),
        in_placements=(heads, heads, heads, kr, heads),
        in_grad_placements=(heads, heads, heads, kr_grad, heads),
        device_mesh=ctx.mesh, redistribute_inputs=True)(
            q_nope, q_rope, k_nope, k_rope, v)


def mla_decode(p, cfg: ModelConfig, x, cache_ckv, cache_kr, context_lens):
    """One-token MLA decode with matrix absorption: scores and values in
    the latent space.  x: [B, 1, d]; cache_ckv [B, S, kv_lora] and
    cache_kr [B, S, rope] are this layer's rows of every slot (row b is
    slot b), written in place at the new token's position
    ``context_lens - 1``; a free row (length 0) writes row 0 of its own
    slot and attends to it alone.  No host read: the step can be
    captured in a CUDA graph."""
    m = cfg.mla
    B, S = cache_ckv.shape[:2]
    H = cfg.num_heads
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    pos = (context_lens.long() - 1).clamp_min(0)
    q_nope, q_rope, c_new, kr_new = _mla_q_and_latent(p, cfg, h, pos[:, None])
    write_rows(cache_ckv, c_new[:, 0], pos)
    write_rows(cache_kr, kr_new[:, 0], pos)
    w_uk = p["w_uk"].reshape(m.kv_lora_rank, H, m.nope_head_dim)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], w_uk)
    scale = (m.nope_head_dim + m.rope_head_dim) ** -0.5
    scores = (torch.einsum("bhr,bsr->bhs", q_lat, cache_ckv)
              + torch.einsum("bhd,bsd->bhs", q_rope[:, 0], cache_kr)
              ).float() * scale
    valid = torch.arange(S, device=x.device)[None, :] <= pos[:, None]
    scores = scores.masked_fill(~valid[:, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out_lat = torch.einsum("bhs,bsr->bhr", probs, cache_ckv)
    w_uv = p["w_uv"].reshape(m.kv_lora_rank, H, m.v_head_dim)
    y = torch.einsum("bhr,rhd->bhd", out_lat, w_uv).reshape(B, 1, -1)
    return y @ p["wo"]


# ---------------------------------------------------------------------------
# MoE (sort-based capacity dispatch)
# ---------------------------------------------------------------------------

# the shared expert's leaves, flat in the FFN's ParameterDict (the JAX tree
# nests them under "shared"; ParameterDict keys cannot nest)
SHARED = "shared_"


def init_moe(cfg: ModelConfig, gen: torch.Generator, dtype):
    """Router [d, E] float32 in any weight dtype, as JAX keeps it; experts
    [E, d, ff] / [E, ff, d]; with shared experts, their fused FFN (no
    ``ln``: it reads the same normed input) under ``shared_*`` keys."""
    mo = cfg.moe
    d, E, ff = cfg.d_model, mo.num_experts, mo.d_ff_expert
    p = {
        "ln": torch.zeros((d,), dtype=dtype, device=gen.device),
        "router": _normal(gen, (d, E), d ** -0.5, torch.float32),
        "w_gate": _normal(gen, (E, d, ff), d ** -0.5, dtype),
        "w_up": _normal(gen, (E, d, ff), d ** -0.5, dtype),
        "w_down": _normal(gen, (E, ff, d), ff ** -0.5, dtype),
    }
    if mo.num_shared:
        sh = init_ffn(cfg, gen, dtype, d_ff=mo.d_ff_shared)
        p.update({SHARED + k: v.data for k, v in sh.items() if k != "ln"})
    return frozen(p)


def moe_capacity(T: int, K: int, E: int, cf: float) -> int:
    return int(min(T * K, max(-(-T * K * cf // E), 16)))


class _AllReduce(torch.autograd.Function):
    """Sum (or mean) over mesh axis ``axis`` in the forward pass.  The
    backward pass hands each rank the cotangent of the replicated result:
    as it is for a sum, divided by the axis size for a mean."""

    @staticmethod
    def forward(fn_ctx, x, mesh, axis: str, op: str):
        import torch.distributed._functional_collectives as funcol
        fn_ctx.scale = 1.0 / mesh.size(mesh.mesh_dim_names.index(axis)) \
            if op == "avg" else 1.0
        return funcol.wait_tensor(funcol.all_reduce(
            x, op, (mesh, mesh.mesh_dim_names.index(axis))))

    @staticmethod
    def backward(fn_ctx, g):
        return g * fn_ctx.scale if fn_ctx.scale != 1.0 else g, None, None, None


class _EnterModelParallel(torch.autograd.Function):
    """The identity in the forward pass; the backward pass sums the
    cotangent over mesh axis ``axis``: the input of a region whose ranks
    each hold a slice of the weights (Megatron's f)."""

    @staticmethod
    def forward(fn_ctx, x, mesh, axis: str):
        fn_ctx.mesh, fn_ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(fn_ctx, g):
        import torch.distributed._functional_collectives as funcol
        mesh = fn_ctx.mesh
        return funcol.wait_tensor(funcol.all_reduce(
            g.contiguous(), "sum",
            (mesh, mesh.mesh_dim_names.index(fn_ctx.axis)))), None, None


def _moe_local(p, cfg: ModelConfig, xt, act, axis_name: Optional[str] = None,
               mesh=None):
    """Sort + capacity-dispatch MoE over tokens xt [T, d]: the (token,
    choice) rows sorted stably by expert fill [E, C, d] slots, C =
    ``moe_capacity``; an expert keeps its first C rows in flat order t·K + k
    and drops the rest.  Expert products are batched matmuls over the
    slots.  Every shape follows from T alone and nothing is read on the
    host, so decode can be captured in a CUDA graph.  Returns (y [T, d],
    Switch aux loss).  With ``axis_name`` (inside ``local_map`` over
    ``mesh``) the experts' FF dims are this rank's slice of that axis, and
    the down-projection is summed over it."""
    mo = cfg.moe
    T, d = xt.shape
    E, K = mo.num_experts, mo.top_k
    C = moe_capacity(T, K, E, mo.capacity_factor)
    M = T * K
    probs = torch.softmax(xt.float() @ p["router"], dim=-1)        # [T, E]
    top_p, top_i = torch.topk(probs, K, dim=-1)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    flat_e = top_i.reshape(-1)                                     # [M]
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    token_of = order // K
    # rows per expert: a compare-and-sum into E bins (bincount would read
    # its input's maximum on the host)
    hits = flat_e[:, None] == torch.arange(E, device=xt.device)    # [M, E]
    group_sizes = hits.sum(dim=0)
    starts = torch.cumsum(group_sizes, dim=0) - group_sizes
    ar = torch.arange(C, device=xt.device)
    slot_rows = (starts[:, None] + ar[None, :]).clamp_max(M - 1)
    slot_valid = ar[None, :] < group_sizes[:, None]
    xe = xt if axis_name is None else \
        _EnterModelParallel.apply(xt, mesh, axis_name)
    xs = xe[token_of]                                              # [M, d]
    slots = xs[slot_rows.reshape(-1)].view(E, C, d) \
        * slot_valid[..., None].to(xt.dtype)
    hidden = act(torch.bmm(slots, p["w_gate"])) * torch.bmm(slots, p["w_up"])
    out_slots = torch.bmm(hidden, p["w_down"])                     # [E, C, d]
    if axis_name is not None:
        out_slots = _AllReduce.apply(out_slots, mesh, axis_name, "sum")
    pos = torch.arange(M, device=xt.device) - starts[e_sorted]
    keep = pos < C
    out_sorted = out_slots[e_sorted, pos.clamp_max(C - 1)] \
        * keep[:, None].to(out_slots.dtype)
    out_tk = out_sorted[torch.argsort(order)].view(T, K, d)
    y = torch.einsum("tkd,tk->td", out_tk, top_p.to(out_tk.dtype))
    frac_tokens = hits.float().mean(dim=0)
    aux = E * torch.sum(frac_tokens * probs.mean(dim=0))
    return y, aux


def moe_forward(p, cfg: ModelConfig, x, ctx: ShardCtx = NULL_CTX):
    """x: [B, L, d] -> (y, aux_loss): every token of the batch routed
    together, plus the shared experts where the config has them.

    With an active mesh (and ``use_shard_map_moe``, the batch dividing the
    data axes and the expert FF dim the model axis) the dispatch runs under
    ``local_map``: tokens stay on their (pod, data) shard, the expert FF
    dims are sharded over the model axis, the down-projections are summed
    over it, and aux is averaged over the data axes (the reference's
    ``shard_map`` branch)."""
    B, L, d = x.shape
    act = _act(cfg.act)
    if (ctx.enabled and ctx.use_shard_map_moe and B % ctx.dp_size == 0
            and cfg.moe.d_ff_expert % ctx.tp_size == 0):
        return _moe_sharded(p, cfg, x, act, ctx)
    h = block_input(x, p["ln"], cfg, ctx)
    y, aux = _moe_local(p, cfg, h.reshape(-1, d), act)
    y = y.view(B, L, d)
    if SHARED + "w_gate" in p:
        zs = act(h @ p[SHARED + "w_gate"]) * (h @ p[SHARED + "w_up"])
        y = y + zs @ p[SHARED + "w_down"]
    return y, aux


def _moe_sharded(p, cfg: ModelConfig, x, act, ctx: ShardCtx):
    """The ``shard_map`` branch of the reference's ``moe_forward``
    (:489-526) as a ``local_map``.  Gradients: an expert weight's is this
    data shard's part (summed over the data axes), the router's the same,
    and the input's is whole on every model rank (the expert path's
    cotangent summed over the model axis by ``_EnterModelParallel``)."""
    from torch.distributed.tensor.experimental import local_map
    mesh, M = ctx.mesh, ctx.model_axis
    d = x.shape[-1]
    bspec = ctx.data_axes if len(ctx.data_axes) > 1 else ctx.data_axes[0]
    w_specs = {"router": (None, None),
               "w_gate": (None, None, M), "w_up": (None, None, M),
               "w_down": (None, M, None),
               SHARED + "w_gate": (None, M), SHARED + "w_up": (None, M),
               SHARED + "w_down": (M, None)}
    names = [k for k in p.keys() if k != "ln"]
    h_pl = placements((bspec, None, None), mesh)

    def body(xt, *ws):
        pp = dict(zip(names, ws))
        xt2 = xt.reshape(-1, d)
        y, aux = _moe_local(pp, cfg, xt2, act, axis_name=M, mesh=mesh)
        if SHARED + "w_gate" in pp:
            xs = _EnterModelParallel.apply(xt2, mesh, M)
            zs = act(xs @ pp[SHARED + "w_gate"]) * (xs @ pp[SHARED + "w_up"])
            y = y + _AllReduce.apply(zs @ pp[SHARED + "w_down"], mesh, M,
                                     "sum")
        for a in ctx.data_axes:
            aux = _AllReduce.apply(aux, mesh, a, "avg")
        return y.reshape(xt.shape), aux

    h = block_input(x, p["ln"], cfg, ctx)
    replicated = placements((), mesh)
    return local_map(
        body, out_placements=(h_pl, replicated),
        in_placements=(h_pl,) + tuple(placements(w_specs[n], mesh)
                                      for n in names),
        in_grad_placements=(h_pl,) + tuple(ctx.data_partial(w_specs[n])
                                           for n in names),
        device_mesh=mesh, redistribute_inputs=True)(
            h, *(p[n] for n in names))
