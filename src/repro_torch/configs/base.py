"""Model configs for the PyTorch port.

A copy of ``BlockSpec``, ``Stage``, the sub-configs, ``ModelConfig``
(with ``block_kinds`` and ``param_count``), ``uniform_stage``,
``local_global_stages``, ``ShapeSpec``, ``SHAPES`` and ``reduce_config``
from the JAX package (``repro/configs/base.py:25-276``).  The port keeps
its own copy so that it imports nothing of ``repro``; the tests hold the
two copies to the same fields, but for the port's own: NoPE and the muP
scalars of ``ModelConfig``, which the JAX package lacks.  Malformed specs
raise ``ValueError`` where the JAX copy asserts.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# mixer kinds: "full" (GQA, full causal), "window" (GQA, sliding window),
#              "mla" (DeepSeek multi-head latent attention), "mamba" (SSD)
# ffn kinds:   "dense" (gated MLP), "moe" (routed experts), "none"


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    mixer: str            # full | window | mla | mamba
    ffn: str              # dense | moe | none
    window: Optional[int] = None  # sliding-window length for mixer=="window"

    def __post_init__(self):
        if self.mixer not in ("full", "window", "mla", "mamba"):
            raise ValueError(f"unknown mixer {self.mixer!r}")
        if self.ffn not in ("dense", "moe", "none"):
            raise ValueError(f"unknown ffn {self.ffn!r}")
        if self.mixer == "window" and not (self.window and self.window > 0):
            raise ValueError("window mixer needs a positive window")


@dataclasses.dataclass(frozen=True)
class Stage:
    pattern: Tuple[BlockSpec, ...]
    repeat: int

    @property
    def num_layers(self) -> int:
        return len(self.pattern) * self.repeat


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0
    d_ff_shared: int = 0
    router_aux_weight: float = 0.01
    capacity_factor: float = 2.0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    stages: Tuple[Stage, ...]
    qk_norm: bool = False
    rope_theta: float = 10000.0
    logit_softcap: Optional[float] = None
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    frontend: str = "none"
    n_prefix_embeds: int = 0
    tie_embeddings: bool = False
    act: str = "silu"             # silu | gelu
    norm_eps: float = 1e-6
    lr_schedule: str = "cosine"
    source: str = ""
    # port-only fields (the JAX package has none of them): no rotary
    # embedding ("nope"), and the muP scalars of granite-4.0-h: the
    # embedding times ``embedding_multiplier``, each mixer's and FFN's
    # output times ``residual_multiplier`` before it joins the residual,
    # attention scores times ``attention_multiplier`` (None: head_dim **
    # -0.5) and the logits divided by ``logits_scaling``
    position_embedding: str = "rope"
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    attention_multiplier: Optional[float] = None
    logits_scaling: float = 1.0

    def __post_init__(self):
        got = sum(s.num_layers for s in self.stages)
        if got != self.num_layers:
            raise ValueError(f"{self.name}: stages cover {got} layers, "
                             f"config says {self.num_layers}")
        if self.position_embedding not in ("rope", "nope"):
            raise ValueError(f"{self.name}: position_embedding "
                             f"{self.position_embedding!r} is neither "
                             f"'rope' nor 'nope'")
        for field in ("embedding_multiplier", "residual_multiplier",
                      "attention_multiplier", "logits_scaling"):
            v = getattr(self, field)
            if v is None and field == "attention_multiplier":
                continue
            if not (isinstance(v, (int, float)) and 0 < v < float("inf")):
                raise ValueError(f"{self.name}: {field} must be a positive "
                                 f"finite number, got {v!r}")

    @property
    def rotary(self) -> bool:
        """Whether attention rotates q and k (RoPE)."""
        return self.position_embedding == "rope"

    @property
    def attn_q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def attn_kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def block_kinds(self):
        """Iterate (stage_idx, pattern_idx, BlockSpec) over unique block slots."""
        for si, st in enumerate(self.stages):
            for pi, blk in enumerate(st.pattern):
                yield si, pi, blk

    def layer_list(self):
        """Flat list of BlockSpec, one per actual layer."""
        out = []
        for st in self.stages:
            for _ in range(st.repeat):
                out.extend(st.pattern)
        return out

    # -- parameter counting (analytic; used for roofline MODEL_FLOPS) ------

    def param_count(self, *, active_only: bool = False) -> int:
        d = self.d_model
        n = 0
        # embeddings (+ untied lm head)
        n += self.vocab_size * d
        if not self.tie_embeddings:
            n += self.vocab_size * d
        if self.n_prefix_embeds:
            n += d * d  # frontend projection stub
        for blk in self.layer_list():
            n += d  # input norm
            if blk.mixer in ("full", "window"):
                n += d * self.attn_q_dim + 2 * d * self.attn_kv_dim
                n += self.attn_q_dim * d
                if self.qk_norm:
                    n += 2 * self.head_dim
            elif blk.mixer == "mla":
                m = self.mla
                n += d * self.num_heads * (m.nope_head_dim + m.rope_head_dim)  # wq
                n += d * (m.kv_lora_rank + m.rope_head_dim)                    # w_dkv
                n += m.kv_lora_rank                                            # kv norm
                n += m.kv_lora_rank * self.num_heads * m.nope_head_dim         # w_uk
                n += m.kv_lora_rank * self.num_heads * m.v_head_dim            # w_uv
                n += self.num_heads * m.v_head_dim * d                         # wo
            elif blk.mixer == "mamba":
                s = self.ssm
                di = s.d_inner(d)
                nh = s.n_heads(d)
                conv_ch = di + 2 * s.n_groups * s.d_state
                n += d * (2 * di + 2 * s.n_groups * s.d_state + nh)  # in_proj
                n += s.d_conv * conv_ch                               # conv
                n += 3 * nh                                           # A_log, D, dt_bias
                n += di                                               # gated norm
                n += di * d                                           # out_proj
            if blk.ffn == "dense":
                n += d  # pre-ffn norm
                n += 3 * d * self.d_ff
            elif blk.ffn == "moe":
                mo = self.moe
                n += d
                n += d * mo.num_experts  # router
                e = mo.num_experts if not active_only else mo.top_k
                n += 3 * d * mo.d_ff_expert * e
                if mo.num_shared:
                    n += 3 * d * mo.d_ff_shared
        return n


def uniform_stage(num_layers: int, mixer: str = "full", ffn: str = "dense",
                  window: Optional[int] = None) -> Tuple[Stage, ...]:
    return (Stage(pattern=(BlockSpec(mixer, ffn, window),), repeat=num_layers),)


def local_global_stages(num_layers: int, local_per_global: int,
                        window: int, ffn: str = "dense") -> Tuple[Stage, ...]:
    """Gemma-3 style N:1 local:global interleave; trailing locals get their
    own stage when num_layers isn't a multiple of the pattern length."""
    plen = local_per_global + 1
    pat = tuple(BlockSpec("window", ffn, window) for _ in range(local_per_global)) \
        + (BlockSpec("full", ffn),)
    reps, rem = divmod(num_layers, plen)
    stages = [Stage(pattern=pat, repeat=reps)]
    if rem:
        tail = tuple(BlockSpec("window", ffn, window) for _ in range(rem))
        stages.append(Stage(pattern=tail, repeat=1))
    return tuple(stages)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str           # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def reduce_config(cfg: ModelConfig, *, layers_per_stage: int = 1,
                  d_model: int = 64, d_ff: int = 128, vocab: int = 256,
                  num_experts: Optional[int] = None) -> ModelConfig:
    """Shrink a config to smoke-test size while preserving its block mix."""
    heads = max(2, min(4, cfg.num_heads))
    kv = 1 if cfg.num_kv_heads < cfg.num_heads else heads
    head_dim = d_model // heads
    stages = []
    for st in cfg.stages:
        pat = [BlockSpec(b.mixer, b.ffn, min(b.window, 16) if b.window else None)
               for b in st.pattern]
        stages.append(Stage(tuple(pat), min(st.repeat, layers_per_stage)))
    stages = tuple(stages)
    nl = sum(s.num_layers for s in stages)
    moe = None
    if cfg.moe is not None:
        ne = num_experts or min(cfg.moe.num_experts, 4)
        moe = MoEConfig(num_experts=ne, top_k=min(cfg.moe.top_k, 2),
                        d_ff_expert=d_ff // 2,
                        num_shared=min(cfg.moe.num_shared, 1),
                        d_ff_shared=d_ff // 2 if cfg.moe.num_shared else 0,
                        capacity_factor=float(ne))
    mla = None
    if cfg.mla is not None:
        mla = MLAConfig(kv_lora_rank=32, rope_head_dim=16, nope_head_dim=head_dim,
                        v_head_dim=head_dim)
    ssm = None
    if cfg.ssm is not None:
        ssm = SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                        n_groups=1, chunk=16)
    return dataclasses.replace(
        cfg, name=cfg.name + "-reduced", num_layers=nl, d_model=d_model,
        num_heads=heads, num_kv_heads=kv, head_dim=head_dim, d_ff=d_ff,
        vocab_size=vocab, stages=stages, moe=moe, mla=mla, ssm=ssm,
        n_prefix_embeds=min(cfg.n_prefix_embeds, 4))
