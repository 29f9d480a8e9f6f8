"""Model assembly: parameter init, prefill, chunked prefill, paged decode.

Counterpart of ``repro/models/model.py``: ``padded_vocab`` (:45-50),
``init_params`` (:53-80), ``model_forward`` (:187-196), ``logits_fn``
(:205-207), ``prefill`` (:210-226), ``init_cache(ring=False)`` (:229-270),
``prefill_chunk`` (:273-344) and ``decode_step`` (:373-438).  Differences:

* layers are a flat ``nn.ModuleList`` in ``cfg.layer_list()`` order, run by
  a Python loop (PyTorch runs eagerly; there is no scan to keep small);
  ``convert.py`` maps them to and from the JAX ``stages`` pytree;
* ``prefill`` returns each layer's K/V (the engine writes them into pages)
  in place of a ring cache;
* ``decode_step`` attends over the paged cache through the paged kernel
  and writes the new token's K/V into it in place;
* ``prefill_chunk`` takes only real tokens (no padding to a fixed shape)
  and one ``pos`` for the batch.

Only dense decoders whose every layer is a ``full`` attention mixer with a
dense FFN run here; other mixers raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L


class Block(nn.Module):
    """One decoder layer: ``attn`` and ``ffn`` parameter dicts."""

    def __init__(self, spec: BlockSpec, attn: nn.ParameterDict,
                 ffn: nn.ParameterDict):
        super().__init__()
        self.spec = spec
        self.attn = attn
        self.ffn = ffn


class Model(nn.Module):
    """Parameters of a dense decoder: ``embed`` [V, d], ``final_norm`` [d],
    ``lm_head`` [d, V] unless embeddings are tied, and ``layers``."""

    def __init__(self, cfg: ModelConfig, top: nn.ParameterDict,
                 layers: List[Block]):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.top = top
        self.layers = nn.ModuleList(layers)

    @property
    def dtype(self) -> torch.dtype:
        return self.top["embed"].dtype

    @property
    def device(self) -> torch.device:
        return self.top["embed"].device


def check_supported(cfg: ModelConfig) -> None:
    for blk in cfg.layer_list():
        if blk.mixer != "full" or blk.ffn != "dense":
            raise NotImplementedError(
                f"{cfg.name}: the port runs full-attention layers with a "
                f"dense FFN only, got mixer={blk.mixer!r} ffn={blk.ffn!r}")
    if cfg.logit_softcap is not None or cfg.n_prefix_embeds:
        raise NotImplementedError(
            f"{cfg.name}: attention softcap and prefix embeddings are not "
            f"ported (the paged decode kernel has no softcap)")


def padded_vocab(cfg: ModelConfig, multiple: int = 256) -> int:
    """Embedding rows padded as the JAX package pads them; padded ids never
    appear in data, but their logits stay in the output (and its argmax)
    like any other never-sampled token."""
    return -(-cfg.vocab_size // multiple) * multiple


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                *, seed: int = 0, dtype=torch.bfloat16,
                device="cuda") -> Model:
    """Random weights drawn on ``device`` from ``generator`` (or a new one
    seeded with ``seed``), scaled as ``repro.models.init_params`` scales
    them.  torch and jax.random give different numbers from one seed: use
    ``convert.from_jax_params`` to compute with the JAX package's weights."""
    dev = resolve_device(device)
    check_supported(cfg)
    gen = generator or torch.Generator(device=dev).manual_seed(seed)
    if gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device}, parameters on {dev}")
    V, d = padded_vocab(cfg), cfg.d_model
    top = {"embed": L._normal(gen, (V, d), d ** -0.5, dtype),
           "final_norm": torch.zeros((d,), dtype=dtype, device=dev)}
    if not cfg.tie_embeddings:
        top["lm_head"] = L._normal(gen, (d, V), d ** -0.5, dtype)
    blocks = [Block(blk, L.init_attention(cfg, gen, dtype),
                    L.init_ffn(cfg, gen, dtype))
              for blk in cfg.layer_list()]
    return Model(cfg, L.frozen(top), blocks)


def embed_tokens(model: Model, tokens):
    return model.top["embed"][tokens]


def logits_fn(model: Model, hidden):
    if model.cfg.tie_embeddings:
        return hidden @ model.top["embed"].T
    return hidden @ model.top["lm_head"]


def _run_layers(model: Model, x, positions, collect: bool):
    cfg = model.cfg
    kv = []
    for blk in model.layers:
        y, (k, v) = L.attn_forward(blk.attn, cfg, x, positions,
                                   blk.spec.window)
        x = x + y
        if collect:
            kv.append((k, v))
        x = x + L.ffn_forward(blk.ffn, cfg, x)
    return L.rms_norm(x, model.top["final_norm"], cfg.norm_eps), kv


def model_forward(model: Model, tokens):
    """Teacher-forcing forward.  Returns (final_hidden [B, S, d], aux_loss);
    aux_loss is 0 for a dense model."""
    x = embed_tokens(model, tokens)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    x, _ = _run_layers(model, x, positions, collect=False)
    return x, torch.zeros((), device=x.device)


def prefill(model: Model, tokens) -> Tuple[torch.Tensor, list]:
    """Process a prompt [B, S].  Returns (last-token logits [B, V], per-layer
    (k, v) of shape [B, S, KV, hd] for the engine to write into pages)."""
    x = embed_tokens(model, tokens)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    x, kv = _run_layers(model, x, positions, collect=True)
    return logits_fn(model, x[:, -1]), kv


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """Linear staging cache for ``prefill_chunk``: ``k``/``v`` of shape
    [n_layers, batch, max_len, KV, hd] with slot == absolute position, and
    ``pos``, the next position (one for the whole batch)."""
    dev = resolve_device(device)
    shp = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shp, dtype=dtype, device=dev),
            "v": torch.zeros(shp, dtype=dtype, device=dev), "pos": 0}


def prefill_chunk(model: Model, cache: dict, tokens):
    """Extend the staging cache by one prompt chunk ``tokens`` [B, C] (all
    real tokens).  Writes K/V at ``cache["pos"]`` onward in place, advances
    ``pos`` by C and returns (logits at the chunk's last token [B, V],
    cache)."""
    cfg = model.cfg
    pos0 = cache["pos"]
    B, C = tokens.shape
    if pos0 + C > cache["k"].shape[2]:
        raise ValueError(f"chunk ends at {pos0 + C}, past the staging cache "
                         f"of {cache['k'].shape[2]} positions")
    x = embed_tokens(model, tokens)
    for i, blk in enumerate(model.layers):
        x = x + L.attn_chunk(blk.attn, cfg, x, cache["k"][i], cache["v"][i],
                             pos0, blk.spec.window)
        x = x + L.ffn_forward(blk.ffn, cfg, x)
    x = L.rms_norm(x, model.top["final_norm"], cfg.norm_eps)
    cache["pos"] = pos0 + C
    return logits_fn(model, x[:, -1]), cache


def decode_step(model: Model, k_pages, v_pages, tokens, block_tables,
                context_lens):
    """One decode iteration over the paged cache.  tokens: [B] (the last
    token of each sequence); k/v_pages: [n_layers, P, page, KV, hd];
    block_tables int32 [B, n_pages]; context_lens int32 [B], counting the
    new token.  Writes the new K/V into the pages and returns logits
    [B, V]."""
    cfg = model.cfg
    x = embed_tokens(model, tokens)[:, None]
    for i, blk in enumerate(model.layers):
        x = x + L.attn_decode(blk.attn, cfg, x, k_pages[i], v_pages[i],
                              block_tables, context_lens)
        x = x + L.ffn_forward(blk.ffn, cfg, x)
    x = L.rms_norm(x, model.top["final_norm"], cfg.norm_eps)
    return logits_fn(model, x[:, 0])
