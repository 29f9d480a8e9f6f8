"""Layers of the decoder: RMSNorm, RoPE, GQA attention, MLA, gated FFN, MoE.

Counterparts of ``repro/models/layers.py``: ``rms_norm`` (:27-31) with its
``(1 + w)`` scale, the half-split ``rope`` (:38-48), ``init_attention`` and
``_qkv`` with optional qk_norm (:59-116, without the sharding
constraints), ``_sdpa`` (:119-132), ``attn_forward`` (:175-183),
``attn_decode`` (:186-207), ``attn_chunk`` (:210-238), ``init_mla``,
``_mla_q_and_latent``, ``mla_forward`` and ``mla_decode`` (:245-356),
``init_ffn`` and ``ffn_forward`` (:363-381), ``init_moe``,
``moe_capacity``, ``_moe_local`` and the plain branch of ``moe_forward``
(:388-472, :527-535; the ``shard_map`` branch waits for the distributed
layer).

Attention goes through the kernel wrappers: ``attn_forward`` and
``attn_chunk`` through ``flash_attention`` (full and window layers),
``attn_decode`` through ``paged_attention`` over the engine's paged cache
(the JAX layer attends over a dense per-slot ring), and ``window_decode``
through ``paged_attention`` over a window layer's per-slot ring, laid out
as whole pages of its slot (the JAX layer's ring with a masked
``_sdpa``).  ``_sdpa`` stays as the plain reference the tests compare the
layers against.  Training goes around the kernels, which run forward
only and refuse inputs that require grad: ``attn_forward(..., train=True)``
attends through ``_sdpa_chunked`` (:135-161), plain einsums over 512-row
query chunks, each rematerialised, as the reference trains (:182).  MLA
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
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.paged_attention.ops import paged_attention


def rms_norm(x, w, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def _act(name: str):
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")   # jax.nn.gelu default
    return F.silu


def rope(x, positions, theta: float):
    """Rotary embedding.  x: [..., L, H, hd]; positions: [..., L]."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs               # [..., L, half]
    cos = torch.cos(ang)[..., None, :]                       # [..., L, 1, half]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def frozen(tensors: dict) -> nn.ParameterDict:
    return nn.ParameterDict(
        {k: nn.Parameter(v, requires_grad=False) for k, v in tensors.items()})


def _normal(gen: torch.Generator, shape, std: float, dtype):
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device) * std).to(dtype)


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


def _qkv(p, cfg: ModelConfig, x, positions):
    B, L, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).view(B, L, H, hd)
    k = (x @ p["wk"]).view(B, L, KV, hd)
    v = (x @ p["wv"]).view(B, L, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask, softcap: Optional[float] = None):
    """Plain reference.  q: [B,Lq,H,hd], k/v: [B,Lk,KV,hd], mask:
    [B or 1, Lq, Lk] bool -> [B, Lq, H*hd]."""
    B, Lq, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Lq, KV, H // KV, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k).float() * hd ** -0.5
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
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
               softcap: Optional[float]):
    """``_sdpa`` of the query rows ``off .. off + len(q)`` over every key."""
    mask = causal_mask(q.shape[1], k.shape[1], window, off, q.device)
    return _sdpa(q, k, v, mask, softcap)


def _sdpa_chunked(q, k, v, window: Optional[int], softcap: Optional[float],
                  chunk: int = 512):
    """Causal ``_sdpa`` over query chunks, so scores take [B, H, chunk, Lk]
    at most; each chunk's body is rematerialised, so the backward pass
    recomputes its scores instead of holding every chunk's probabilities.
    Plain and differentiable: the training path.  Above ``chunk`` rows Lq
    must be a multiple of it, as the reference asserts."""
    Lq = q.shape[1]
    if Lq <= chunk:
        return _sdpa(q, k, v, causal_mask(Lq, Lq, window, device=q.device),
                     softcap)
    if Lq % chunk:
        raise ValueError(f"{Lq} query rows are not a multiple of the "
                         f"{chunk}-row chunk")
    outs = [checkpoint(_sdpa_rows, q[:, off:off + chunk], k, v, off, window,
                       softcap, use_reentrant=False)
            for off in range(0, Lq, chunk)]
    return torch.cat(outs, dim=1)


def attn_forward(p, cfg: ModelConfig, x, positions, window: Optional[int],
                 train: bool = False):
    """Full-sequence causal attention: through the flash kernel (prefill),
    or with ``train`` through the plain, differentiable ``_sdpa_chunked``.
    Returns (y, (k, v)) so prefill can fill the cache."""
    B, L, _ = x.shape
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q, k, v = _qkv(p, cfg, h, positions)
    if train:
        y = _sdpa_chunked(q, k, v, window, cfg.logit_softcap)
    else:
        y = flash_attention(q, k, v, causal=True, window=window,
                            softcap=cfg.logit_softcap)
    return y.reshape(B, L, -1) @ p["wo"], (k, v)


def attn_decode(p, cfg: ModelConfig, x, k_pages, v_pages, block_tables,
                context_lens):
    """One-token decode over the paged cache.  x: [B, 1, d]; k/v_pages:
    [P, page, KV, hd] of this layer; block_tables int32 [B, n_pages];
    context_lens int32 [B] counts the new token, which sits at position
    ``context_lens - 1``.  Writes the new K/V into its page slot in place
    (one indexed store each), then attends through the paged kernel."""
    B = x.shape[0]
    page = k_pages.shape[1]
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    pos = context_lens.long() - 1
    q, k_new, v_new = _qkv(p, cfg, h, pos[:, None])
    slot = block_tables.long().gather(1, (pos // page)[:, None])[:, 0]
    idx = slot * page + pos % page
    k_pages.view(-1, *k_pages.shape[2:])[idx] = k_new[:, 0]
    v_pages.view(-1, *v_pages.shape[2:])[idx] = v_new[:, 0]
    y = paged_attention(q[:, 0], k_pages, v_pages, block_tables, context_lens)
    return y.reshape(B, 1, -1) @ p["wo"]


def window_decode(p, cfg: ModelConfig, x, k_ring, v_ring, ring_tables,
                  context_lens, size: int):
    """One-token decode of a window layer over its per-slot ring of
    ``size`` = min(window, max_len) rows: the window branch of the JAX
    ``attn_decode``.  x: [B, 1, d]; k/v_ring: [slots * n, page, KV, hd] of
    this layer, slot b's ring being pages ``ring_tables[b]`` (int32 [B,
    n], n * page >= size); context_lens int32 [B] counts the new token.
    The new K/V goes to ring row ``pos % size``, pos = context_lens - 1,
    and the paged kernel attends over rows 0 .. min(context_lens, size) -
    1: every row the ring holds once it has wrapped, else the positions
    so far, as JAX's mask ``slot <= pos | pos >= S`` keeps.  Rows hold K
    after RoPE, so their order does not change the scores.  A free row of
    length 0 writes row 0 of its own ring and attends over nothing
    (zeros); with length 1 it writes and reads row 0.  No host read."""
    B = x.shape[0]
    page = k_ring.shape[1]
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    pos = (context_lens.long() - 1).clamp_min(0)
    q, k_new, v_new = _qkv(p, cfg, h, pos[:, None])
    row = pos % size
    idx = ring_tables.long().gather(1, (row // page)[:, None])[:, 0] * page \
        + row % page
    k_ring.view(-1, *k_ring.shape[2:])[idx] = k_new[:, 0]
    v_ring.view(-1, *v_ring.shape[2:])[idx] = v_new[:, 0]
    y = paged_attention(q[:, 0], k_ring, v_ring, ring_tables,
                        context_lens.clamp_max(size))
    return y.reshape(B, 1, -1) @ p["wo"]


def attn_chunk(p, cfg: ModelConfig, x, cache_k, cache_v, pos0: int,
               window: Optional[int]):
    """Chunked prefill: extend a LINEAR (slot == position) staging cache by
    the C tokens of x [B, C, d] starting at ``pos0``; cache_k/v:
    [B, S, KV, hd] with S >= pos0 + C, written in place.  Flash attention
    sees K/V cut to ``pos0 + C`` rows, so its tail alignment
    (q_offset = Lk - Lq) puts the chunk's queries at pos0..pos0+C-1."""
    B, C, _ = x.shape
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    positions = (pos0 + torch.arange(C, device=x.device))[None].expand(B, C)
    q, k_new, v_new = _qkv(p, cfg, h, positions)
    cache_k[:, pos0:pos0 + C] = k_new
    cache_v[:, pos0:pos0 + C] = v_new
    y = flash_attention(q, cache_k[:, :pos0 + C], cache_v[:, :pos0 + C],
                        causal=True, window=window, softcap=cfg.logit_softcap)
    return y.reshape(B, C, -1) @ p["wo"]


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


def ffn_forward(p, cfg: ModelConfig, x):
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    z = _act(cfg.act)(h @ p["w_gate"]) * (h @ p["w_up"])
    return z @ p["w_down"]


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


def _mla_q_and_latent(p, cfg: ModelConfig, h, positions):
    m = cfg.mla
    B, L, _ = h.shape
    q = (h @ p["wq"]).view(B, L, cfg.num_heads,
                           m.nope_head_dim + m.rope_head_dim)
    q_nope, q_rope = q.split([m.nope_head_dim, m.rope_head_dim], dim=-1)
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    c_kv, k_rope = (h @ p["w_dkv"]).split([m.kv_lora_rank, m.rope_head_dim],
                                          dim=-1)
    c_kv = rms_norm(c_kv, p["kv_norm"], cfg.norm_eps)
    k_rope = rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, c_kv, k_rope


def mla_forward(p, cfg: ModelConfig, x, positions, chunk: int = 512):
    """Full-sequence MLA (expanded form) over query chunks of ``chunk``, so
    the scores take [B, H, chunk, L] at most.  Any L: the last chunk may be
    short (the JAX layer asserts L % 512 == 0 above 512).  Returns (y,
    (c_kv [B, L, kv_lora], k_rope [B, L, rope])) for the latent cache."""
    m = cfg.mla
    B, L, _ = x.shape
    H = cfg.num_heads
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q_nope, q_rope, c_kv, k_rope = _mla_q_and_latent(p, cfg, h, positions)
    k_nope = (c_kv @ p["w_uk"]).view(B, L, H, m.nope_head_dim)
    v = (c_kv @ p["w_uv"]).view(B, L, H, m.v_head_dim)
    scale = (m.nope_head_dim + m.rope_head_dim) ** -0.5
    ys = []
    for q0 in range(0, L, chunk):
        qn, qr = q_nope[:, q0:q0 + chunk], q_rope[:, q0:q0 + chunk]
        scores = (torch.einsum("bqhd,bshd->bhqs", qn, k_nope)
                  + torch.einsum("bqhd,bsd->bhqs", qr, k_rope)
                  ).float() * scale
        mask = causal_mask(qn.shape[1], L, offset=q0, device=x.device)
        scores = scores.masked_fill(~mask[:, None], -1e30)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        ys.append(torch.einsum("bhqs,bshd->bqhd", probs, v))
    y = torch.cat(ys, dim=1).reshape(B, L, H * m.v_head_dim)
    return y @ p["wo"], (c_kv, k_rope)


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
    idx = torch.arange(B, device=x.device) * S + pos
    cache_ckv.view(B * S, -1)[idx] = c_new[:, 0]
    cache_kr.view(B * S, -1)[idx] = kr_new[:, 0]
    w_uk = p["w_uk"].view(m.kv_lora_rank, H, m.nope_head_dim)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], w_uk)
    scale = (m.nope_head_dim + m.rope_head_dim) ** -0.5
    scores = (torch.einsum("bhr,bsr->bhs", q_lat, cache_ckv)
              + torch.einsum("bhd,bsd->bhs", q_rope[:, 0], cache_kr)
              ).float() * scale
    valid = torch.arange(S, device=x.device)[None, :] <= pos[:, None]
    scores = scores.masked_fill(~valid[:, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out_lat = torch.einsum("bhs,bsr->bhr", probs, cache_ckv)
    w_uv = p["w_uv"].view(m.kv_lora_rank, H, m.v_head_dim)
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


def _moe_local(p, cfg: ModelConfig, xt, act):
    """Sort + capacity-dispatch MoE over tokens xt [T, d]: the (token,
    choice) rows sorted stably by expert fill [E, C, d] slots, C =
    ``moe_capacity``; an expert keeps its first C rows in flat order t·K + k
    and drops the rest.  Expert products are batched matmuls over the
    slots.  Every shape follows from T alone and nothing is read on the
    host, so decode can be captured in a CUDA graph.  Returns (y [T, d],
    Switch aux loss)."""
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
    xs = xt[token_of]                                              # [M, d]
    slots = xs[slot_rows.reshape(-1)].view(E, C, d) \
        * slot_valid[..., None].to(xt.dtype)
    hidden = act(torch.bmm(slots, p["w_gate"])) * torch.bmm(slots, p["w_up"])
    out_slots = torch.bmm(hidden, p["w_down"])                     # [E, C, d]
    pos = torch.arange(M, device=xt.device) - starts[e_sorted]
    keep = pos < C
    out_sorted = out_slots[e_sorted, pos.clamp_max(C - 1)] \
        * keep[:, None].to(out_slots.dtype)
    out_tk = out_sorted[torch.argsort(order)].view(T, K, d)
    y = torch.einsum("tkd,tk->td", out_tk, top_p.to(out_tk.dtype))
    frac_tokens = hits.float().mean(dim=0)
    aux = E * torch.sum(frac_tokens * probs.mean(dim=0))
    return y, aux


def moe_forward(p, cfg: ModelConfig, x):
    """x: [B, L, d] -> (y, aux_loss): every token of the batch routed
    together, plus the shared experts where the config has them."""
    B, L, d = x.shape
    act = _act(cfg.act)
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    y, aux = _moe_local(p, cfg, h.reshape(-1, d), act)
    y = y.view(B, L, d)
    if SHARED + "w_gate" in p:
        zs = act(h @ p[SHARED + "w_gate"]) * (h @ p[SHARED + "w_up"])
        y = y + zs @ p[SHARED + "w_down"]
    return y, aux
