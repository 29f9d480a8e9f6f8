"""Layers of the dense GQA decoder: RMSNorm, RoPE, attention, gated FFN.

Counterparts of ``repro/models/layers.py``: ``rms_norm`` (:27-31) with its
``(1 + w)`` scale, the half-split ``rope`` (:38-48), ``init_attention`` and
``_qkv`` with optional qk_norm (:59-116, without the sharding
constraints), ``_sdpa`` (:119-132), ``attn_forward`` (:175-183),
``attn_decode`` (:186-207), ``attn_chunk`` (:210-238), ``init_ffn`` and
``ffn_forward`` (:363-381).

Attention goes through the kernel wrappers: ``attn_forward`` and
``attn_chunk`` through ``flash_attention``, ``attn_decode`` through
``paged_attention`` over the engine's paged cache (the JAX layer attends
over a dense per-slot ring).  ``_sdpa`` stays as the plain reference the
tests compare the layers against.  Parameters are ``nn.ParameterDict``s
keyed like the JAX pytree, frozen (no gradients).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

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


def attn_forward(p, cfg: ModelConfig, x, positions, window: Optional[int]):
    """Full-sequence causal attention (prefill) through the flash kernel.
    Returns (y, (k, v)) so prefill can fill the cache."""
    B, L, _ = x.shape
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q, k, v = _qkv(p, cfg, h, positions)
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
