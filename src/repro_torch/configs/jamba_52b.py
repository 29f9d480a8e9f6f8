"""jamba-v0.1-52b [hybrid] — 32L d_model=4096, attention layers 32H (GQA
kv=8), d_ff=14336, vocab=65536, MoE 16 experts top-2; Mamba:attention
interleave 7:1 (one attention layer per 8), MoE on alternate layers.
Copy of ``repro/configs/jamba_52b.py``.  [arXiv:2403.19887; hf]"""
from repro_torch.configs.base import (BlockSpec, ModelConfig, MoEConfig,
                                      SSMConfig, Stage)

# Jamba block: 8 layers, attention at index 4, MoE FFN on odd layers.
_PATTERN = tuple(
    BlockSpec("full" if i == 4 else "mamba", "moe" if i % 2 == 1 else "dense")
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    stages=(Stage(pattern=_PATTERN, repeat=4),),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14336),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk=256),
    rope_theta=10000.0,   # the release's attention layers use no PE; the
                          # JAX package keeps RoPE for uniformity
    act="silu",
    source="arXiv:2403.19887",
)
