"""Model assembly: parameter init, prefill, chunked prefill, decode.

Counterpart of ``repro/models/model.py``: ``_init_block`` (:28-42),
``padded_vocab`` (:45-50), ``init_params`` (:53-80), ``model_forward``
(:187-196), ``logits_fn`` (:205-207), ``prefill`` (:210-226),
``init_cache(ring=False)`` (:229-270), ``prefill_chunk`` (:273-344) and
``decode_step`` (:373-438).  Differences:

* layers are a flat ``nn.ModuleList`` in ``cfg.layer_list()`` order, run by
  a Python loop (PyTorch runs eagerly; there is no scan to keep small);
  ``convert.py`` maps them to and from the JAX ``stages`` pytree;
* ``prefill`` returns each layer's decode state (K/V of an attention layer,
  which the engine writes into pages; conv tail and SSM state of a mamba
  layer, which it writes into a state slot) in place of a ring cache;
* ``decode_step`` attends over the paged cache through the paged kernel,
  writes the new token's K/V into it in place, and updates the active
  slots' mamba states in place;
* ``prefill_chunk`` takes only real tokens (no padding to a fixed shape)
  and one ``pos`` for the batch.

Layers run ``full`` attention or ``mamba`` mixers, each with a dense FFN or
none; other mixers and FFNs raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssd

MIXERS, FFNS = ("full", "mamba"), ("dense", "none")


def layer_caches(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """Per layer, in ``cfg.layer_list()`` order: the cache that holds its
    decode state ("kv": K/V pages of an attention layer; "ssm": the conv
    history and SSM state of a mamba layer) and the layer's rank among the
    layers of that cache, which indexes the cache's stacked tensors."""
    ranks = {"kv": 0, "ssm": 0}
    out = []
    for blk in cfg.layer_list():
        kind = "ssm" if blk.mixer == "mamba" else "kv"
        out.append((kind, ranks[kind]))
        ranks[kind] += 1
    return out


class Block(nn.Module):
    """One decoder layer: an ``attn`` (full mixer) or ``mixer`` (mamba)
    parameter dict, and an ``ffn`` dict unless ``spec.ffn == "none"``."""

    def __init__(self, spec: BlockSpec, attn: Optional[nn.ParameterDict] = None,
                 ffn: Optional[nn.ParameterDict] = None,
                 mixer: Optional[nn.ParameterDict] = None):
        super().__init__()
        if (attn is None) != (spec.mixer != "full") or \
                (mixer is None) != (spec.mixer != "mamba") or \
                (ffn is None) != (spec.ffn == "none"):
            raise ValueError(f"parameters do not match the layer {spec}")
        self.spec = spec
        self.attn = attn
        self.mixer = mixer
        self.ffn = ffn

    @property
    def parts(self) -> Tuple[str, ...]:
        """The parameter dicts this layer holds, as named in the JAX tree."""
        return tuple(k for k in ("attn", "mixer", "ffn")
                     if getattr(self, k) is not None)


class Model(nn.Module):
    """Parameters of a decoder: ``embed`` [V, d], ``final_norm`` [d],
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
        if blk.mixer not in MIXERS or blk.ffn not in FFNS:
            raise NotImplementedError(
                f"{cfg.name}: the port runs {'/'.join(MIXERS)} mixers with "
                f"a {'/'.join(FFNS)} FFN, got mixer={blk.mixer!r} "
                f"ffn={blk.ffn!r}")
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
    blocks = []
    for blk in cfg.layer_list():
        attn = (L.init_attention(cfg, gen, dtype) if blk.mixer == "full"
                else None)
        mixer = ssd.init_mamba(cfg, gen, dtype) if blk.mixer == "mamba" \
            else None
        ffn = L.init_ffn(cfg, gen, dtype) if blk.ffn == "dense" else None
        blocks.append(Block(blk, attn, ffn, mixer))
    return Model(cfg, L.frozen(top), blocks)


def embed_tokens(model: Model, tokens):
    return model.top["embed"][tokens]


def logits_fn(model: Model, hidden):
    if model.cfg.tie_embeddings:
        return hidden @ model.top["embed"].T
    return hidden @ model.top["lm_head"]


def _run_layers(model: Model, x, positions, collect: bool):
    cfg = model.cfg
    states = []
    for blk in model.layers:
        if blk.attn is not None:
            y, st = L.attn_forward(blk.attn, cfg, x, positions,
                                   blk.spec.window)
        elif collect:
            y, st = ssd.mamba_forward(blk.mixer, cfg, x, return_state=True)
        else:
            y, st = ssd.mamba_forward(blk.mixer, cfg, x), None
        x = x + y
        if collect:
            states.append(st)
        if blk.ffn is not None:
            x = x + L.ffn_forward(blk.ffn, cfg, x)
    return L.rms_norm(x, model.top["final_norm"], cfg.norm_eps), states


def model_forward(model: Model, tokens):
    """Teacher-forcing forward.  Returns (final_hidden [B, S, d], aux_loss);
    aux_loss is 0 for a dense model."""
    x = embed_tokens(model, tokens)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    x, _ = _run_layers(model, x, positions, collect=False)
    return x, torch.zeros((), device=x.device)


def prefill(model: Model, tokens) -> Tuple[torch.Tensor, list]:
    """Process a prompt [B, S].  Returns (last-token logits [B, V], one
    decode state per layer): (k, v) of shape [B, S, KV, hd] for an
    attention layer, for the engine to write into pages; (conv tail
    {"x", "B", "C"} [B, K-1, ·], SSM state [B, H, P, N] f32) for a mamba
    layer, for the engine to write into a state slot."""
    x = embed_tokens(model, tokens)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    x, states = _run_layers(model, x, positions, collect=True)
    return logits_fn(model, x[:, -1]), states


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
    if any(blk.attn is None for blk in model.layers):
        raise NotImplementedError(
            "prefill_chunk supports full attention only: mamba states are "
            "not chunk-resumable (the engine prefills them in one shot)")
    pos0 = cache["pos"]
    B, C = tokens.shape
    if pos0 + C > cache["k"].shape[2]:
        raise ValueError(f"chunk ends at {pos0 + C}, past the staging cache "
                         f"of {cache['k'].shape[2]} positions")
    x = embed_tokens(model, tokens)
    for i, blk in enumerate(model.layers):
        x = x + L.attn_chunk(blk.attn, cfg, x, cache["k"][i], cache["v"][i],
                             pos0, blk.spec.window)
        if blk.ffn is not None:
            x = x + L.ffn_forward(blk.ffn, cfg, x)
    x = L.rms_norm(x, model.top["final_norm"], cfg.norm_eps)
    cache["pos"] = pos0 + C
    return logits_fn(model, x[:, -1]), cache


def decode_step(model: Model, tokens, cache: dict):
    """One decode iteration.  tokens: [B] (the last token of each sequence).

    ``cache`` holds the batch's view of each cache the model's layers use
    (``layer_caches``), as ``PagedKVCache.decode_view`` and
    ``SSMStateCache.decode_view`` give it.  Attention layers attend over
    ``k_pages``/``v_pages`` [n kv layers, P, page, KV, hd] through
    ``block_tables`` int32 [B, n_pages] and ``context_lens`` int32 [B]
    (counting the new token), and write the new K/V into the pages.  Mamba
    layers read and update rows ``slots`` int64 [B] of ``conv`` {"x", "B",
    "C": [n ssm layers, slots, K-1, ·]} and ``ssm`` [n ssm layers, slots,
    H, P, N] f32 in place.  Returns logits [B, V]."""
    cfg = model.cfg
    x = embed_tokens(model, tokens)[:, None]
    for blk, (kind, i) in zip(model.layers, layer_caches(cfg)):
        if kind == "kv":
            x = x + L.attn_decode(blk.attn, cfg, x, cache["k_pages"][i],
                                  cache["v_pages"][i], cache["block_tables"],
                                  cache["context_lens"])
        else:
            slots = cache["slots"]
            conv = {k: v[i] for k, v in cache["conv"].items()}
            ssm = cache["ssm"][i]
            y, (new_conv, new_ssm) = ssd.mamba_decode(
                blk.mixer, cfg, x, {k: v[slots] for k, v in conv.items()},
                ssm[slots])
            for k, v in new_conv.items():
                conv[k][slots] = v
            ssm[slots] = new_ssm
            x = x + y
        if blk.ffn is not None:
            x = x + L.ffn_forward(blk.ffn, cfg, x)
    x = L.rms_norm(x, model.top["final_norm"], cfg.norm_eps)
    return logits_fn(model, x[:, 0])
