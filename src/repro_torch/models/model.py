"""Model assembly: parameter init, prefill, chunked prefill, decode.

Counterpart of ``repro/models/model.py``: ``_init_block`` (:28-42),
``padded_vocab`` (:45-50), ``init_params`` (:53-80), ``embed_tokens``
(:177-184), ``model_forward`` (:187-196), ``lm_head_weight`` (:199-202),
``logits_fn`` (:205-207), ``prefill`` (:210-226), ``init_cache``
(:229-270), ``prefill_chunk`` (:273-344), ``ring_convert_cache`` (:347)
and ``decode_step`` (:373-438, as ``ring_decode_step``; ``decode_step``
here is the engine's paged step), and the engine's ``_splice``
(``repro/engine/engine.py:136-145``, as ``splice_ring``), with the blocks
of ``_apply_block``
(:87-122) and their sharding constraints under a ``ShardCtx``.
Differences:

* layers are a flat ``nn.ModuleList`` in ``cfg.layer_list()`` order, run by
  a Python loop (PyTorch runs eagerly; there is no scan to keep small);
  ``convert.py`` maps them to and from the JAX ``stages`` pytree;
* serving runs two layer loops, each holding the residual policy (how a
  block's output joins the residual stream, the FFN, the final norm)
  once, while each entry point hands it only its per-layer mixer call.
  ``_fused_layers`` folds each add into the next norm through the fused
  kernels of ``kernels/decode_fused`` (``add_rms_norm``; RoPE with the
  K/V store, and the gate, in the layers): ``decode_step`` runs it, and
  so do ``prefill``, ``prefill_chunk`` and the serving ``model_forward``
  over a prompt's rows on CPU and CUDA tensors outside a mesh.
  ``_plain_layers`` takes each add, norm and constraint on its own: those
  three under a ``ShardCtx`` and on meta tensors, and
  ``ring_decode_step``.  ``_serving_layers`` alone picks the route
  (``_fused_route``).  Training keeps a loop of its own (``_train_layer``);
* ``prefill`` returns each layer's decode state (K/V of a full or window
  attention layer, which the engine writes into pages or into the
  layer's ring; c_kv and k_rope of an MLA layer, which it writes into a
  latent-cache slot; conv tail and SSM state of a mamba layer, which it
  writes into a state slot) in place of a ring cache;
* ``decode_step`` attends over the paged cache through the paged kernel,
  writes the new token's K/V into it in place, attends over each window
  layer's ring of ``min(window, max_len)`` rows through the same kernel
  (the ring laid out as whole pages of its slot), and updates the latent
  rows and the mamba states in place, every slot at once (the engine runs
  it at one fixed shape and, on the card, replays it from a CUDA graph);
* ``prefill_chunk`` takes only real tokens (no padding to a fixed shape)
  and one ``pos`` for the batch;
* ``init_cache`` defaults to ``ring=False`` (the staging layout, stacked
  over layers, that the engine and ``prefill_chunk`` use); ``ring=True``
  gives the reference's per-layer ring layout, which ``ring_decode_step``
  reads and updates in place, and which ``to_ring_cache`` builds from
  ``prefill``'s states.  The ring layout has a batch dim to shard, which
  the paged cache has not: the dry run's decode cells and the engine
  under a mesh run it (``splice_ring`` copies a prompt's ring into a
  slot);
* ``model_forward(..., train=True)`` is the reference's training forward
  (``_run_stages`` with ``remat``, :136-170): plain, differentiable
  attention and scan (``layers._sdpa_chunked``, ``ssd.ssd_chunked``), each
  layer rematerialised with ``torch.utils.checkpoint`` (the reference
  checkpoints each repeat of a stage and, within a multi-block pattern,
  each block: one layer here either way), computing with the tensors it
  is handed by parameter name (the trainer's bf16 casts of its fp32
  masters).  The serving forward goes through the kernels, which run
  forward only.

The config's muP scalars hold on every path: the embedding times
``embedding_multiplier``, each block's output times
``residual_multiplier`` as it joins the residual (``layers.residual_add``,
on the fused loop folded into ``add_rms_norm``), the logits divided by
``logits_scaling``; NoPE (``position_embedding`` "nope") and
``attention_multiplier`` reach every full and window attention path, and
an MLA layer, whose rotary part and scale are its own, refuses both.

Layers run ``full`` or ``window`` attention, ``mla`` or ``mamba`` mixers,
each with a dense FFN, a MoE FFN or none; full and window attention cap
their scores at ``cfg.logit_softcap`` where it is set, on every path, as
the reference's ``_sdpa`` does (MLA has no cap there either); window
layers may differ in size.  Window and MLA layers keep their parameters
under ``attn``, as the JAX tree does.  Configs with stub-frontend prefix
embeddings (``n_prefix_embeds``) hold ``prefix_proj``; ``model_forward``
and ``prefill`` take the embeddings, and the engine serves such configs
text-only, as the JAX engine does.
"""
from __future__ import annotations

from functools import partial
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.context import (NULL_CTX, ShardCtx, _is_dtensor,
                                            local_rows, replicated_like,
                                            sharded_scope)
from repro_torch.kernels.decode_fused.ops import add_rms_norm
from repro_torch.models import layers as L
from repro_torch.models import ssd

MIXERS, FFNS = ("full", "window", "mla", "mamba"), ("dense", "moe", "none")
CACHE_OF = {"full": "kv", "window": "win", "mla": "mla", "mamba": "ssm"}
ATTN_MIXERS = ("full", "window", "mla")     # layers that hold ``attn``


def layer_caches(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """Per layer, in ``cfg.layer_list()`` order: the cache that holds its
    decode state ("kv": K/V pages of a full attention layer; "win": the
    per-slot K/V ring of a window layer; "mla": the latent rows c_kv and
    k_rope of an MLA layer; "ssm": the conv history and SSM state of a
    mamba layer) and the layer's rank among the layers of that cache,
    which indexes the cache's stacked tensors."""
    ranks = {"kv": 0, "win": 0, "mla": 0, "ssm": 0}
    out = []
    for blk in cfg.layer_list():
        kind = CACHE_OF.get(blk.mixer, "kv")
        out.append((kind, ranks[kind]))
        ranks[kind] += 1
    return out


class Block(nn.Module):
    """One decoder layer: an ``attn`` (full, window or mla mixer) or
    ``mixer`` (mamba) parameter dict, and an ``ffn`` dict (dense or moe)
    unless ``spec.ffn == "none"``."""

    def __init__(self, spec: BlockSpec, attn: Optional[nn.ParameterDict] = None,
                 ffn: Optional[nn.ParameterDict] = None,
                 mixer: Optional[nn.ParameterDict] = None):
        super().__init__()
        if (attn is None) != (spec.mixer not in ATTN_MIXERS) or \
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
    ``lm_head`` [d, V] unless embeddings are tied, ``prefix_proj`` [d, d]
    where the config has prefix embeddings, and ``layers``."""

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
        if blk.mixer == "mla":
            for field, ok in (("position_embedding", cfg.rotary),
                              ("attention_multiplier",
                               cfg.attention_multiplier is None)):
                if not ok:
                    raise NotImplementedError(
                        f"{cfg.name}: an MLA layer keeps its own rotary "
                        f"part and scale; {field} "
                        f"{getattr(cfg, field)!r} is not supported there")


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
    if dev.type == "meta":       # shapes only: the dry run's parameters
        gen = L.MetaGenerator()
    else:
        gen = generator or torch.Generator(device=dev).manual_seed(seed)
    if gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device}, parameters on {dev}")
    V, d = padded_vocab(cfg), cfg.d_model
    top = {"embed": L._normal(gen, (V, d), d ** -0.5, dtype),
           "final_norm": torch.zeros((d,), dtype=dtype, device=dev)}
    if not cfg.tie_embeddings:
        top["lm_head"] = L._normal(gen, (d, V), d ** -0.5, dtype)
    if cfg.n_prefix_embeds:
        top["prefix_proj"] = L._normal(gen, (d, d), d ** -0.5, dtype)
    blocks = []
    make_attn = {"full": L.init_attention, "window": L.init_attention,
                 "mla": L.init_mla}
    make_ffn = {"dense": L.init_ffn, "moe": L.init_moe}
    for blk in cfg.layer_list():
        attn = (make_attn[blk.mixer](cfg, gen, dtype)
                if blk.mixer in make_attn else None)
        mixer = ssd.init_mamba(cfg, gen, dtype) if blk.mixer == "mamba" \
            else None
        ffn = (make_ffn[blk.ffn](cfg, gen, dtype) if blk.ffn in make_ffn
               else None)
        blocks.append(Block(blk, attn, ffn, mixer))
    return Model(cfg, L.frozen(top), blocks)


def _top(model: Model, name: str, params: Optional[Dict] = None):
    """``model.top[name]``, or its stand-in ``params["top." + name]`` where
    ``params`` (tensors by parameter name) holds one."""
    return (params or {}).get(f"top.{name}", model.top[name])


def _embed(w, tokens):
    """Rows ``tokens`` of the table w; a DTensor table gathers through
    ``F.embedding``, whose DTensor rule keeps a vocab-sharded table
    sharded."""
    if _is_dtensor(w):
        return torch.nn.functional.embedding(tokens, w)
    return w[tokens]


def _scaled_embed(model: Model, tokens, params: Optional[Dict] = None):
    """Rows ``tokens`` of the embedding, times the config's
    ``embedding_multiplier`` where it is not 1."""
    x = _embed(_top(model, "embed", params), tokens)
    m = model.cfg.embedding_multiplier
    return x if m == 1.0 else x * m


def embed_tokens(model: Model, tokens, prefix_embeds=None,
                 params: Optional[Dict] = None, ctx: ShardCtx = NULL_CTX):
    """Token embeddings [B, S, d] (times ``embedding_multiplier``); with
    ``prefix_embeds`` [B, n, d] (a config with ``n_prefix_embeds`` only),
    their projection comes first, [B, n + S, d].  ``params``: tensors by
    parameter name (``top.embed``, ``top.prefix_proj``) to use in place of
    the model's own."""
    x = _scaled_embed(model, tokens, params)
    if model.cfg.n_prefix_embeds and prefix_embeds is not None:
        pre = prefix_embeds.to(x.dtype) @ _top(model, "prefix_proj", params)
        x = torch.cat([pre, x], dim=1)
    return ctx.constraint(x, ctx.batch_spec_entry(x.shape[0]),
                          ctx.seq_entry(x.shape[1]), None)


def lm_head_weight(model: Model, params: Optional[Dict] = None):
    """The output projection [d, V]: ``embed`` transposed where embeddings
    are tied.  ``params``: tensors by parameter name (``top.embed``,
    ``top.lm_head``) to use in place of the model's own."""
    if model.cfg.tie_embeddings:
        return _top(model, "embed", params).T
    return _top(model, "lm_head", params)


def logits_fn(model: Model, hidden):
    """hidden @ the head, divided by ``logits_scaling`` where it is not 1."""
    logits = hidden @ lm_head_weight(model)
    s = model.cfg.logits_scaling
    return logits if s == 1.0 else logits / s


def _ffn(spec: BlockSpec, p, cfg: ModelConfig, x, ctx: ShardCtx = NULL_CTX):
    """The layer's FFN output and its aux loss (0 unless MoE)."""
    if spec.ffn == "moe":
        return L.moe_forward(p, cfg, x, ctx)
    return L.ffn_forward(p, cfg, x, ctx), 0.0


def _between_layers(x, ctx: ShardCtx):
    """The residual stream's constraint after each layer: batch over the
    data axes, tokens over the model axis (sequence parallelism)."""
    return ctx.constraint(x, ctx.batch_spec_entry(x.shape[0]),
                          ctx.seq_entry(x.shape[1]), None)


def _fused_route(x, ctx: ShardCtx) -> bool:
    """Whether a serving forward over x takes the fused glue: a CPU or CUDA
    tensor (the wrappers' plain chains, or the kernels) outside a mesh."""
    return not ctx.enabled and x.device.type in ("cpu", "cuda")


def _fused_layers(model: Model, x, mix, collect: bool = False, aux=None,
                  rows: bool = True):
    """The serving layers through the fused glue, and with them the
    residual policy of every fused path: each block's output joins the
    residual stream times ``residual_multiplier``, added by the next
    block's norm (``add_rms_norm``, the final norm included) where that
    block is a full or window attention layer or a dense FFN
    (``ffn_decode`` past the norm), and first, ahead of the block's own
    norm, where it is an MLA, mamba or MoE block.  ``mix(i, block, x) ->
    (y, state)`` is the caller's mixer call for layer i, handed an
    attention layer's normed input, else the residual stream.  x [B, L, d]
    runs as rows [B * L, d] with ``rows`` (a prompt or chunk; the MoE FFN
    sees them as [B, L, d]), else as it is (``decode_step``'s [B, 1, d]).
    Returns (the final norm's output [B, L, d], each layer's state where
    ``collect``, ``aux`` plus the MoE aux losses where ``aux`` is
    given)."""
    cfg = model.cfg
    eps, alpha = cfg.norm_eps, cfg.residual_multiplier
    shape = x.shape
    if rows:
        x = x.reshape(-1, shape[-1])
    y = None                  # the last block's output, not yet in x
    states = []
    for i, blk in enumerate(model.layers):
        if blk.spec.mixer in ("full", "window"):
            x, h = add_rms_norm(x, y, blk.attn["ln"], eps, alpha)
        else:
            x = h = x if y is None else L.residual_add(x, y, alpha)
        y, st = mix(i, blk, h)
        if collect:
            states.append(st)
        if blk.spec.ffn == "dense":
            x, h = add_rms_norm(x, y, blk.ffn["ln"], eps, alpha)
            y = L.ffn_decode(blk.ffn, cfg, h)
        elif blk.spec.ffn == "moe":
            x = L.residual_add(x, y, alpha)
            y, a = L.moe_forward(blk.ffn, cfg, x.view(shape) if rows else x)
            y = y.view(x.shape) if rows else y
            aux = None if aux is None else aux + a
    _, h = add_rms_norm(x, y, model.top["final_norm"], eps, alpha)
    return h.view(shape) if rows else h, states, aux


def _plain_layers(model: Model, x, positions, collect: bool,
                  ctx: ShardCtx = NULL_CTX, mix=None, aux=None):
    """The serving layers through the plain layers, and with them the
    residual policy of every plain path: each block's output added on its
    own (``residual_add``, times ``residual_multiplier``), the FFN through
    ``_ffn``, ``_between_layers`` after each layer, then the final
    ``rms_norm``.  It runs prefill and its chunks under a mesh or on meta
    tensors, ``ring_decode_step``, and is the tests' oracle of the fused
    route.  ``mix`` is as in ``_fused_layers``, handed the residual
    stream; by default a prompt's at ``positions`` (``_prompt_mixer``).
    Returns as ``_fused_layers``."""
    cfg = model.cfg
    alpha = cfg.residual_multiplier
    mix = mix or _prompt_mixer(model, x, positions, collect, ctx, False)
    states = []
    for i, blk in enumerate(model.layers):
        y, st = mix(i, blk, x)
        x = L.residual_add(x, y, alpha)
        if collect:
            states.append(st)
        if blk.ffn is not None:
            y, a = _ffn(blk.spec, blk.ffn, cfg, x, ctx)
            x = L.residual_add(x, y, alpha)
            aux = None if aux is None else aux + a
        x = _between_layers(x, ctx)
    return L.rms_norm(x, model.top["final_norm"], cfg.norm_eps), states, aux


def _serving_layers(model: Model, x, mixer, collect: bool = False,
                    ctx: ShardCtx = NULL_CTX, aux=None):
    """The serving layers over a prompt or chunk x [B, L, d], the one place
    its route is decided: ``_fused_layers`` where ``_fused_route`` says so,
    else ``_plain_layers``; ``mixer(fused)`` is the caller's mixer call
    for that route."""
    if _fused_route(x, ctx):
        return _fused_layers(model, x, mixer(True), collect, aux)
    return _plain_layers(model, x, None, collect, ctx, mixer(False), aux)


def _prompt_mixer(model: Model, x, positions, collect: bool, ctx: ShardCtx,
                  fused: bool):
    """The mixer call of ``prefill`` and the serving ``model_forward`` over
    a prompt x [B, S, d] at ``positions``: full and window attention
    through ``attn_prefill`` on the fused route's rows, else
    ``attn_forward``; MLA through ``mla_forward`` and mamba through
    ``mamba_forward`` (with its state where ``collect``) over [B, S, d]."""
    cfg = model.cfg
    B, S, d = x.shape

    def mix(i, blk, x):
        if blk.spec.mixer in ("full", "window"):
            if fused:
                return L.attn_prefill(blk.attn, cfg, x, B, blk.spec.window)
            return L.attn_forward(blk.attn, cfg, x, positions,
                                  blk.spec.window, ctx)
        xb = x.view(B, S, d) if fused else x
        if blk.spec.mixer == "mla":
            y, st = L.mla_forward(blk.attn, cfg, xb, positions, ctx)
        elif collect:
            y, st = ssd.mamba_forward(blk.mixer, cfg, xb, ctx,
                                      return_state=True)
        else:
            y, st = ssd.mamba_forward(blk.mixer, cfg, xb, ctx), None
        return y.reshape(B * S, d) if fused else y, st
    return mix


def _chunk_mixer(model: Model, x, cache: dict, pos0: int, ctx: ShardCtx,
                 fused: bool):
    """The mixer call of ``prefill_chunk`` over a chunk x [B, C, d] at
    ``pos0`` onward: each layer writes its K/V into layer i of the staging
    ``cache`` and attends over its first ``pos0 + C`` rows, through
    ``attn_prefill`` on the fused route's rows, else ``attn_chunk``."""
    cfg = model.cfg
    B = x.shape[0]

    def mix(i, blk, x):
        k, v = cache["k"][i], cache["v"][i]
        if fused:
            return L.attn_prefill(blk.attn, cfg, x, B, blk.spec.window, pos0,
                                  k, v)[0], None
        return L.attn_chunk(blk.attn, cfg, x, k, v, pos0, blk.spec.window,
                            ctx), None
    return mix


def _train_layer(spec: BlockSpec, parts: dict, cfg: ModelConfig, x,
                 positions, ctx: ShardCtx = NULL_CTX):
    """One layer of the training forward: (x, aux loss).  Under a mesh each
    block's output takes its cotangent with the tokens whole: the
    sequence-sharded residual would hand it back sharded over the tokens,
    which the block's last matmul cannot flatten into its rows."""
    bspec = ctx.batch_spec_entry(x.shape[0])
    if spec.mixer in ("full", "window"):
        y, _ = L.attn_forward(parts["attn"], cfg, x, positions, spec.window,
                              ctx, train=True)
    elif spec.mixer == "mla":
        y, _ = L.mla_forward(parts["attn"], cfg, x, positions, ctx)
    else:
        y = ssd.mamba_forward(parts["mixer"], cfg, x, ctx, train=True)
    alpha = cfg.residual_multiplier
    x = L.residual_add(x, ctx.grad_constraint(y, bspec, None, None), alpha)
    aux = 0.0
    if "ffn" in parts:
        y, aux = _ffn(spec, parts["ffn"], cfg, x, ctx)
        x = L.residual_add(x, ctx.grad_constraint(y, bspec, None, None),
                           alpha)
    return _between_layers(x, ctx), aux


def _positions(S: int, device):
    """Positions 0 .. S-1 as [1, S]: every row of a batch shares them (RoPE
    broadcasts them over the batch)."""
    return torch.arange(S, device=device)[None]


def model_forward(model: Model, tokens, prefix_embeds=None,
                  ctx: ShardCtx = NULL_CTX, *,
                  train: bool = False, remat: bool = True,
                  params: Optional[Dict[str, torch.Tensor]] = None):
    """Teacher-forcing forward.  Returns (final_hidden [B, S, d], aux_loss):
    the MoE layers' Switch losses summed, 0 for a model without MoE.  S
    counts the prefix positions.

    Serving (``train=False``), attention and the scan run the kernels.
    ``train=True`` runs the plain, differentiable training path, each layer
    rematerialised unless ``remat`` is False, with ``params`` (tensors by
    ``named_parameters`` name) in place of the model's own where given;
    above 512 tokens, a full or window attention layer needs a multiple of
    512, as the reference's."""
    if params and not train:
        raise ValueError("params replace weights in the training forward "
                         "only")
    params = params or {}
    with sharded_scope(ctx):
        x = embed_tokens(model, tokens, prefix_embeds, params, ctx)
        positions = _positions(x.shape[1], x.device)
        if not train:
            mixer = partial(_prompt_mixer, model, x, positions, False, ctx)
            x, _, aux = _serving_layers(model, x, mixer, ctx=ctx,
                                        aux=torch.zeros((), device=x.device))
            return x, aux
        aux = torch.zeros((), device=x.device)
        for i, blk in enumerate(model.layers):
            parts = {part: {k: params.get(f"layers.{i}.{part}.{k}", v)
                            for k, v in getattr(blk, part).items()}
                     for part in blk.parts}
            if remat:
                x, a = checkpoint(_train_layer, blk.spec, parts, model.cfg,
                                  x, positions, ctx, use_reentrant=False)
            else:
                x, a = _train_layer(blk.spec, parts, model.cfg, x, positions,
                                    ctx)
            aux = aux + a
        return (L.rms_norm(x, _top(model, "final_norm", params),
                           model.cfg.norm_eps), aux)


def prefill(model: Model, tokens, prefix_embeds=None,
            ctx: ShardCtx = NULL_CTX) -> Tuple[torch.Tensor, list]:
    """Process a prompt [B, S] (after ``prefix_embeds`` [B, n, d], if
    given: then S counts the n prefix positions too).  Returns (last-token
    logits [B, V], one decode state per layer): (k, v) of shape [B, S, KV,
    hd] for a full or window attention layer, for the engine to write into
    pages or into the layer's ring; (c_kv [B, S, kv_lora], k_rope [B, S,
    rope]) for an MLA layer, for the engine to
    write into a latent-cache slot; (conv tail {"x", "B", "C"} [B, K-1, ·],
    SSM state [B, H, P, N] f32) for a mamba layer, for the engine to write
    into a state slot.  Under a mesh the kernels run on each rank's shard
    (``local_map``)."""
    with sharded_scope(ctx):
        x = embed_tokens(model, tokens, prefix_embeds, ctx=ctx)
        mixer = partial(_prompt_mixer, model, x,
                        _positions(x.shape[1], x.device), True, ctx)
        x, states, _ = _serving_layers(model, x, mixer, True, ctx)
        x = ctx.constraint(x, ctx.batch_spec_entry(x.shape[0]), None, None)
        return logits_fn(model, x[:, -1]), states


def _ring_layer(cfg: ModelConfig, blk: BlockSpec, batch: int, max_len: int,
                dtype, dev) -> dict:
    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)
    if blk.mixer in ("full", "window"):
        S = min(blk.window, max_len) if blk.window else max_len
        shp = (batch, S, cfg.num_kv_heads, cfg.head_dim)
        return {"k": z(*shp), "v": z(*shp)}
    if blk.mixer == "mla":
        m = cfg.mla
        return {"ckv": z(batch, max_len, m.kv_lora_rank),
                "kr": z(batch, max_len, m.rope_head_dim)}
    s = cfg.ssm
    di, gn, K1 = s.d_inner(cfg.d_model), s.n_groups * s.d_state, s.d_conv - 1
    return {"conv": {"x": z(batch, K1, di), "B": z(batch, K1, gn),
                     "C": z(batch, K1, gn)},
            "ssm": z(batch, s.n_heads(cfg.d_model), s.head_dim, s.d_state,
                     dt=torch.float32)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               dtype=torch.bfloat16, device="cuda", ring: bool = False) -> dict:
    """Empty cache.  ``ring=False``: the linear staging cache for
    ``prefill_chunk``, ``k``/``v`` of shape [n_layers, batch, max_len, KV,
    hd] with slot == absolute position, and ``pos``, the next position (one
    for the whole batch).  Window layers stage here too, at full length;
    the engine moves their last rows into the layer's ring when the prompt
    is complete (``WindowCache.write``), ``ring_convert_cache`` into the
    ring layout.

    ``ring=True``: the reference's decode layout, one dict per layer:
    ``k``/``v`` [batch, S, KV, hd] with S = min(window, max_len) for a window
    layer (slot ``t % S``) and ``max_len`` for a full one; ``ckv``
    [batch, max_len, kv_lora] and ``kr`` [batch, max_len, rope] for MLA;
    ``conv`` {"x", "B", "C": [batch, K-1, ·]} and ``ssm`` [batch, H, P, N]
    float32 for mamba; and ``pos`` int32 [batch], each row's next
    position."""
    dev = resolve_device(device)
    if ring:
        return {"layers": [_ring_layer(cfg, blk, batch, max_len, dtype, dev)
                           for blk in cfg.layer_list()],
                "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}
    shp = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shp, dtype=dtype, device=dev),
            "v": torch.zeros(shp, dtype=dtype, device=dev), "pos": 0}


def _to_ring(k, S: int):
    """The last min(L, S) timesteps of k [B, L, ...] at slots t % S of a
    ring of S, zero elsewhere: slices and a concatenation (no scatter)."""
    Lt = k.shape[1]
    if Lt <= S:
        return torch.cat([k, k.new_zeros((k.shape[0], S - Lt) + k.shape[2:])],
                         dim=1)
    tail = k[:, Lt - S:]
    shift = (Lt - S) % S          # tail row j goes to slot (Lt - S + j) % S
    return torch.cat([tail[:, S - shift:], tail[:, :S - shift]], dim=1)


def to_ring_cache(cfg: ModelConfig, states: list, max_len: int,
                  length: int) -> dict:
    """The ring cache (``init_cache(..., ring=True)``) of ``prefill``'s
    states for prompts of ``length`` positions, as the reference's
    ``prefill`` builds it (``_to_ring``)."""
    layers = []
    batch = None
    for blk, st in zip(cfg.layer_list(), states):
        if blk.mixer in ("full", "window"):
            S = min(blk.window, max_len) if blk.window else max_len
            layers.append({"k": _to_ring(st[0], S), "v": _to_ring(st[1], S)})
        elif blk.mixer == "mla":
            layers.append({"ckv": _to_ring(st[0], max_len),
                           "kr": _to_ring(st[1], max_len)})
        else:
            layers.append({"conv": dict(st[0]), "ssm": st[1]})
        batch = st[1].shape[0]
    dev = states[0][1].device
    return {"layers": layers,
            "pos": torch.full((batch,), length, dtype=torch.int32,
                              device=dev)}


def ring_convert_cache(cfg: ModelConfig, cache: dict, max_len: int,
                       length: int) -> dict:
    """A finished staging cache (``init_cache(..., ring=False)``, as
    ``prefill_chunk`` leaves it, ``length`` valid rows) in the ring layout
    ``ring_decode_step`` reads: each attention layer's first ``length``
    rows through ``_to_ring`` (a window layer keeps the last
    min(length, window) rows at slots t % S)."""
    layers = []
    for i, blk in enumerate(cfg.layer_list()):
        S = min(blk.window, max_len) if blk.window else max_len
        layers.append({"k": _to_ring(cache["k"][i][:, :length], S),
                       "v": _to_ring(cache["v"][i][:, :length], S)})
    B = cache["k"].shape[1]
    return {"layers": layers,
            "pos": torch.full((B,), cache["pos"], dtype=torch.int32,
                              device=cache["k"].device)}


def _leaf_pairs(a, b):
    """(leaf of a, leaf of b) over two trees of dicts of the same keys."""
    if isinstance(a, dict):
        for k in a:
            yield from _leaf_pairs(a[k], b[k])
    else:
        yield a, b


def _put_row(leaf, src, slot: int):
    """leaf[slot] = src[0] in place (leaf [B, ...], src [1, ...]).  On a
    DTensor leaf, src is first placed as leaf is with its batch whole, and
    the rank whose shard holds row ``slot`` stores it into its local
    tensor: no other row is touched."""
    if not _is_dtensor(leaf):
        leaf[slot] = src[0]
        return
    from torch.distributed.tensor import Replicate
    src = replicated_like(src, leaf).redistribute(
        leaf.device_mesh, tuple(Replicate() if pl.is_shard(0) else pl
                                for pl in leaf.placements))
    first, n = local_rows(leaf.device_mesh, leaf.placements, leaf.shape[0])
    if first <= slot < first + n:
        leaf.to_local()[slot - first] = src.to_local()[0]


def splice_ring(cache: dict, one: dict, slot: int) -> dict:
    """Copy the one-request ring cache ``one`` (``to_ring_cache`` or
    ``ring_convert_cache`` of one prompt) into row ``slot`` of every leaf
    of the ring cache ``cache`` (``init_cache(..., ring=True)``, placed or
    not), ``pos[slot]`` included, in place: the reference's engine
    ``_splice``.  Full, window, MLA and mamba leaves alike.  On DTensor
    leaves whose batch is split over the data axes only the rank holding
    the row writes it (``_put_row``).  Returns ``cache``."""
    with torch.no_grad():
        for layer, src in zip(cache["layers"], one["layers"]):
            for leaf, s in _leaf_pairs(layer, src):
                _put_row(leaf, s, slot)
        _put_row(cache["pos"], one["pos"], slot)
    return cache


def ring_decode_step(model: Model, tokens, cache: dict,
                     ctx: ShardCtx = NULL_CTX):
    """One decode iteration over the ring cache (``init_cache(...,
    ring=True)``): the reference's ``decode_step``.  tokens: [B, 1] int.
    Each layer reads and updates its entry in place: attention over the
    dense ring through the plain ``_sdpa``, MLA through ``mla_decode``,
    mamba through ``mamba_decode``, in ``_plain_layers``; ``pos`` advances
    by one.  Returns (logits [B, V], cache)."""
    cfg = model.cfg
    pos = cache["pos"]

    def mix(i, blk, x):
        c = cache["layers"][i]
        if blk.spec.mixer in ("full", "window"):
            return L.ring_attn_decode(blk.attn, cfg, x, c["k"], c["v"], pos,
                                      blk.spec.window, ctx), None
        if blk.spec.mixer == "mla":
            return L.mla_decode(blk.attn, cfg, x, c["ckv"], c["kr"],
                                pos + 1), None
        return ssd.mamba_decode(blk.mixer, cfg, x, c["conv"], c["ssm"])
    with sharded_scope(ctx):
        x = _between_layers(_scaled_embed(model, tokens), ctx)
        x = _plain_layers(model, x, None, False, ctx, mix)[0]
        logits = logits_fn(model, x[:, 0])
        cache["pos"] = pos + 1
    return logits, cache


def prefill_chunk(model: Model, cache: dict, tokens, ctx: ShardCtx = NULL_CTX):
    """Extend the staging cache by one prompt chunk ``tokens`` [B, C] (all
    real tokens).  Writes K/V at ``cache["pos"]`` onward in place, advances
    ``pos`` by C and returns (logits at the chunk's last token [B, V],
    cache).  A MoE FFN routes the chunk's tokens alone, as in JAX.  Under
    a mesh the staging cache must be placed by
    ``distributed.sharding.place_staging``, and each layer writes and
    attends on each rank's shard (``layers._chunk_sharded``, which raises
    on a cache placed otherwise); outside one, CPU and CUDA tensors take
    the fused loop (``_serving_layers``)."""
    if any(b.mixer not in ("full", "window") for b in model.cfg.layer_list()):
        raise NotImplementedError(
            "prefill_chunk supports full/window attention only: mla and "
            "mamba states are not chunk-resumable (the engine prefills them "
            "in one shot)")
    pos0 = cache["pos"]
    B, C = tokens.shape
    if pos0 + C > cache["k"].shape[2]:
        raise ValueError(f"chunk ends at {pos0 + C}, past the staging cache "
                         f"of {cache['k'].shape[2]} positions")
    with sharded_scope(ctx):
        x = _between_layers(_scaled_embed(model, tokens), ctx)
        mixer = partial(_chunk_mixer, model, x, cache, pos0, ctx)
        x = _serving_layers(model, x, mixer, ctx=ctx)[0]
        x = ctx.constraint(x, ctx.batch_spec_entry(B), None, None)
        cache["pos"] = pos0 + C
        return logits_fn(model, x[:, -1]), cache


def decode_step(model: Model, tokens, cache: dict):
    """One decode iteration over every slot: tokens [B] int, the last token
    of each row, row b being slot b; ``cache``, the engine's view of the
    caches its layers use (``layer_caches``), as their ``decode_view``s
    give them.  A full attention layer writes the new K/V into its pages
    and attends over ``context_lens`` tokens (the new one counted); the
    i-th window layer does so in its ring, layer ``rank`` of
    ``win_stacks[j]`` where ``(j, rank) = win_where[i]``; an MLA layer in
    its latent rows; a mamba layer updates its states in place.  The
    residual policy is ``_fused_layers``'s, over [B, 1, d].  No host read
    and no host-built tensor: the engine captures the step in a CUDA
    graph.  Returns logits [B, V]."""
    cfg = model.cfg
    where, lens = layer_caches(cfg), cache.get("context_lens")

    def mix(i, blk, h):
        kind, r = where[i]
        if kind == "kv":
            return L.attn_decode(blk.attn, cfg, h, cache["k_pages"][r],
                                 cache["v_pages"][r], cache["block_tables"],
                                 lens), None
        if kind == "win":
            j, rank = cache["win_where"][r]
            k, v, tables, size = cache["win_stacks"][j]
            return L.attn_decode(blk.attn, cfg, h, k[rank], v[rank], tables,
                                 lens, size), None
        if kind == "mla":
            return L.mla_decode(blk.attn, cfg, h, cache["ckv"][r],
                                cache["kr"][r], lens), None
        return ssd.mamba_decode(blk.mixer, cfg, h,
                                {k: v[r] for k, v in cache["conv"].items()},
                                cache["ssm"][r])
    x = embed_tokens(model, tokens)[:, None]
    h = _fused_layers(model, x, mix, rows=False)[0]
    return logits_fn(model, h[:, 0])
